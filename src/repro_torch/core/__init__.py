"""The self-tuning core (copies of the JAX package's numpy modules):

knobs     — system-setting space
metrics   — per-window metrics repository + outlier removal
progress  — remaining-time objective (training)
gp / bo   — loss-aware Gaussian-process BO with EI acquisition
reconfig  — reconfiguration taxonomy + cost model
tuner     — the Tuning Manager state machine
lru       — bounded cache of step callables, ``aot_compile``
"""
from repro_torch.core.bo import LossAwareBO, expected_improvement
from repro_torch.core.gp import GaussianProcess
from repro_torch.core.knobs import Knob, KnobSpace, setting_key
from repro_torch.core.lru import LRUCache
from repro_torch.core.metrics import MetricsRepository, remove_outliers
from repro_torch.core.progress import (FittedProgress,
                                       estimate_remaining_time, fit_progress)
from repro_torch.core.reconfig import (ReconfigCostModel, ReconfigPlan,
                                       classify, plan)
from repro_torch.core.tuner import TunerConfig, TuningManager

__all__ = [
    "Knob", "KnobSpace", "setting_key", "LRUCache",
    "GaussianProcess", "LossAwareBO", "expected_improvement",
    "FittedProgress", "fit_progress", "estimate_remaining_time",
    "MetricsRepository", "remove_outliers",
    "ReconfigCostModel", "ReconfigPlan", "classify", "plan",
    "TunerConfig", "TuningManager",
]
