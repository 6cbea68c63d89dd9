"""Serving: continuous-batching engine over the paged KV pool, traffic
generators and the serving knob space."""
from repro_torch.serving.engine import Request, ServingEngine, serve_loop
from repro_torch.serving.knobs import (DEFAULT_SERVING_SETTING,
                                       SERVING_RELAYOUT_KNOBS,
                                       serving_knob_space)
from repro_torch.serving.pool import PagedKVPool, TRASH_BLOCK

__all__ = ["Request", "ServingEngine", "serve_loop", "PagedKVPool",
           "TRASH_BLOCK", "DEFAULT_SERVING_SETTING",
           "SERVING_RELAYOUT_KNOBS", "serving_knob_space"]
