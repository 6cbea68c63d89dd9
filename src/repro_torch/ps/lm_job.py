"""LM training as a self-tunable PS job (the JAX package's
``ps/lm_job.py``).

Wraps the model (``repro_torch.models``) and the step
(``repro_torch.ps.stepfn``) in the job interface the paper workloads use,
so the TuningManager can drive real LM training: Type II knobs rebuild
the step, a staleness change resizes the gradient queue, and
``mesh_split`` (Type I-b) relocates the parameter and optimizer shards
onto a new (dp, tp) mesh: via ODMR (``odmr.relocate_now``) or the
checkpoint + restore baseline, per the plan's method.  The job runs on
the CUDA device unless ``device`` is given (``"cpu"``: the plain
versions); with more than one device it runs one process a device
(``torchrun``), every rank holding its shards, and every rank calls the
job's methods in the same order.
"""
from __future__ import annotations

import shutil
import tempfile

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core.knobs import Knob, KnobSpace
from repro_torch.core.reconfig import ReconfigPlan
from repro_torch.core.tree import tree_map
from repro_torch.data.synthetic import lm_batch_iterator
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import (MeshSpec, shape_of,
                                              single_device_meshspec)
from repro_torch.launch.mesh import make_meshspec, world
from repro_torch.models import lm
from repro_torch.optim import make_optimizer
from repro_torch.ps import odmr
from repro_torch.ps.stepfn import (StepKnobs, build_train_step, state_specs,
                                   train_state_shapes)
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
                 n_devices: int | None = None, device=None):
        self.cfg = cfg
        self.tc = tc or TrainConfig()
        self.batch, self.seq, self.seed = batch, seq, seed
        self.n_devices = n_devices or world()[1]
        self.device = resolve_device(device)
        self._ms_cache: dict[str, MeshSpec] = {}
        self._setting: dict | None = None   # the placement of the state
        self.eps = 1.0   # drivers override

    # ------------------------------------------------------------------ mesh
    def meshspec(self, setting: dict) -> MeshSpec:
        split = setting.get("mesh_split", f"{self.n_devices}x1")
        if split not in self._ms_cache:
            dp, tp = (int(x) for x in split.split("x"))
            self._ms_cache[split] = (single_device_meshspec() if dp * tp == 1
                                     else make_meshspec(dp, tp))
        return self._ms_cache[split]

    def specs(self, setting: dict):
        """The state's specs under ``setting`` (its mesh and staleness)."""
        shapes = train_state_shapes(self.cfg, self.tc,
                                    knobs=setting_to_stepknobs(setting))
        return state_specs(shapes, self.meshspec(setting))

    def placement(self):
        """(ms, specs) of the state as last placed, or (None, None) on one
        device: ``CheckpointManager``'s ``placement``."""
        if self._setting is None or self.n_devices == 1:
            return None, None
        return self.meshspec(self._setting), self.specs(self._setting)

    # ----------------------------------------------------------------- state
    def init_state(self, setting: dict, seed: int = 0) -> dict:
        """Random parameters from ``seed`` (``lm.init_params``), zero
        optimizer state, ``step`` 0 and, for staleness > 0, a zero bf16
        gradient queue, on the job's device, placed per the setting (every
        rank draws the whole parameters and keeps its shards)."""
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
        return self._place(state, setting)

    def _place(self, state, setting, old: dict | None = None):
        """The state placed per ``setting``, from its placement per ``old``
        (None: whole)."""
        self._setting = dict(setting)
        ms = self.meshspec(setting)
        if ms.n_devices == 1:           # every setting has one device
            return state
        if old is None:
            return odmr.relocate_now(state, self.specs(setting), ms)
        # the queue already has the new staleness (the adapter's first half)
        old = dict(old, staleness=setting.get("staleness", 0))
        return odmr.relocate_now(state, self.specs(setting), ms,
                                 self.specs(old), self.meshspec(old))

    # ------------------------------------------------------------------ step
    def step_builder(self, setting: dict):
        ms = self.meshspec(setting)
        return build_train_step(self.cfg, self.tc,
                                setting_to_stepknobs(setting),
                                ms=ms if ms.n_devices > 1 else None)

    # --------------------------------------------------------------- adapter
    def state_adapter(self, state, plan: ReconfigPlan):
        state = make_staleness_adapter(torch.bfloat16)(state, plan)
        if "I-b" not in plan.kinds:
            return state
        if plan.method == "odmr":
            return self._place(state, plan.new, plan.old)
        return self._baseline(state, plan)

    def _baseline(self, state, plan: ReconfigPlan):
        """CKP + MDR: quiesce, save the state under the old placement,
        restore it onto the new mesh (each rank reading its new shards)."""
        import torch.distributed as dist

        from repro_torch.checkpoint import restore_pytree, save_pytree
        rank, size = world()
        old = dict(plan.old, staleness=plan.new.get("staleness", 0))
        box = [tempfile.mkdtemp(prefix="lmjob_ckp_") if rank == 0 else None]
        if size > 1:                        # one directory for every rank
            dist.broadcast_object_list(box, src=0)
        d = box[0]
        try:
            save_pytree(state, d, step=0, ms=self.meshspec(old),
                        specs=self.specs(old))
            state.clear()                   # the state given is spent
            state, _ = restore_pytree(self.empty_state(plan.new), d, step=0,
                                      ms=self.meshspec(plan.new),
                                      specs=self.specs(plan.new))
        finally:
            if size > 1:
                dist.barrier()
            if rank == 0:
                shutil.rmtree(d, ignore_errors=True)
        self._setting = dict(plan.new)
        return state

    def empty_state(self, setting):
        """Uninitialised tensors of this rank's shards of the state under
        ``setting`` (a restore's template)."""
        ms = self.meshspec(setting)
        shapes = train_state_shapes(self.cfg, self.tc,
                                    knobs=setting_to_stepknobs(setting))

        def empty(s, spec):
            shape = list(shape_of(s))
            for i, e in enumerate(spec):
                shape[i] //= ms.size_of(e)
            return torch.empty(shape, dtype=s[1], device=self.device)
        return tree_map(empty, shapes, state_specs(shapes, ms))

    # ------------------------------------------------------------------ data
    def batches(self, seed: int = 0):
        return lm_batch_iterator(self.cfg, self.batch, self.seq, seed,
                                 device=self.device)
