"""LM training as a self-tunable PS job (the JAX package's
``ps/lm_job.py``).

Wraps the model (``repro_torch.models``) and the step
(``repro_torch.ps.stepfn``) in the job interface the paper workloads use,
so the TuningManager can drive real LM training: Type II knobs rebuild
the step, and a staleness change resizes the gradient queue.  The job
runs on the CUDA device unless ``device`` is given (``"cpu"``: the plain
versions).  ``mesh_split`` (Type I-b: relocating the state onto another
(dp, tp) mesh) comes with the mesh slice: a plan with ``"I-b"`` raises.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core.knobs import Knob, KnobSpace
from repro_torch.core.reconfig import ReconfigPlan
from repro_torch.core.tree import tree_map
from repro_torch.data.synthetic import lm_batch_iterator
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.optim import make_optimizer
from repro_torch.ps.stepfn import StepKnobs, build_train_step
from repro_torch.ps.trainer import make_staleness_adapter


def lm_knob_space(n_devices: int = 1) -> KnobSpace:
    knobs = [
        Knob("microbatches", "ordinal", (1, 2, 4)),
        Knob("remat", "nominal", ("none", "dots", "full")),
        Knob("compression", "nominal", ("none", "bf16", "int8")),
        Knob("staleness", "ordinal", (0, 1, 2)),
        Knob("k_chunk", "ordinal", (256, 512, 1024)),
    ]
    if n_devices > 1:
        splits, dp = [], 1
        while dp <= n_devices:
            if n_devices % dp == 0:
                splits.append(f"{dp}x{n_devices // dp}")
            dp *= 2
        knobs.append(Knob("mesh_split", "nominal", tuple(splits)))
    return KnobSpace(tuple(knobs))


DEFAULT_LM_SETTING = {"microbatches": 1, "remat": "none",
                      "compression": "none", "staleness": 0, "k_chunk": 512}


def setting_to_stepknobs(setting: dict) -> StepKnobs:
    return StepKnobs(
        microbatches=setting.get("microbatches", 1),
        remat=setting.get("remat", "none"),
        compression=setting.get("compression", "none"),
        staleness=setting.get("staleness", 0),
        k_chunk=setting.get("k_chunk", 1024),
        ce_chunk=setting.get("ce_chunk", 0),
    )


class LMJob:
    def __init__(self, cfg: ModelConfig, tc: TrainConfig | None = None,
                 batch: int = 8, seq: int = 128, seed: int = 0,
                 n_devices: int = 1, device=None):
        self.cfg = cfg
        self.tc = tc or TrainConfig()
        self.batch, self.seq, self.seed = batch, seq, seed
        self.n_devices = n_devices
        self.device = resolve_device(device)
        self.eps = 1.0   # drivers override

    def init_state(self, setting: dict, seed: int = 0) -> dict:
        """Random parameters from ``seed`` (``lm.init_params``), zero
        optimizer state, ``step`` 0 and, for staleness > 0, a zero bf16
        gradient queue, all on the job's device."""
        params = lm.init_params(self.cfg, seed, device=self.device)
        opt_init, _ = make_optimizer(self.tc)
        state = {"params": params, "opt": opt_init(params),
                 "step": torch.zeros((), dtype=torch.int32,
                                     device=self.device)}
        s = setting.get("staleness", 0)
        if s > 0:
            state["grad_queue"] = tree_map(
                lambda p: torch.zeros((s,) + tuple(p.shape),
                                      dtype=torch.bfloat16,
                                      device=p.device), params)
        return state

    def step_builder(self, setting: dict):
        return build_train_step(self.cfg, self.tc,
                                setting_to_stepknobs(setting))

    def state_adapter(self, state, plan: ReconfigPlan):
        if "I-b" in plan.kinds:
            raise NotImplementedError(
                f"plan {plan.kinds} moves the state onto another mesh "
                f"(mesh_split): the mesh slice is not ported yet")
        return make_staleness_adapter(torch.bfloat16)(state, plan)

    def batches(self, seed: int = 0):
        return lm_batch_iterator(self.cfg, self.batch, self.seq, seed,
                                 device=self.device)
