"""Serving: continuous-batching engine over the state pools, traffic
generators, the serving knob space and the SLO-penalized objective the
tuner scores it with."""
from repro_torch.serving.engine import Request, ServingEngine, serve_loop
from repro_torch.serving.knobs import (DEFAULT_SERVING_SETTING,
                                       SERVING_RELAYOUT_KNOBS,
                                       serving_knob_space)
from repro_torch.serving.objective import ServingObjective
from repro_torch.serving.pool import (PagedKVPool, SSMStatePool, StatePool,
                                      TRASH_BLOCK, make_state_pool)

__all__ = ["Request", "ServingEngine", "serve_loop", "PagedKVPool",
           "SSMStatePool", "StatePool", "make_state_pool", "TRASH_BLOCK",
           "DEFAULT_SERVING_SETTING", "SERVING_RELAYOUT_KNOBS",
           "serving_knob_space", "ServingObjective"]
