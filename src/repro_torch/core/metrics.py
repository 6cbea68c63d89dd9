"""Per-iteration execution-metrics repository (paper §III, Fig. 4).

Records are quadruples <j, X_i, t_i^j, l_i^j>. ``windows()`` groups them into
per-setting windows and applies the 1.5-IQR outlier rule (paper cites [33],
ISLR) to the losses before the progress fit — occasional abnormal-loss
iterations must not poison H_i.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.knobs import setting_key


@dataclass
class IterationRecord:
    j: int
    setting_id: int
    t: float       # execution time of iteration j
    loss: float


@dataclass
class SettingWindow:
    setting_id: int
    setting: dict
    start_loss: float           # l_i — loss just before this window
    iters: list[int] = field(default_factory=list)
    times: list[float] = field(default_factory=list)
    losses: list[float] = field(default_factory=list)


def remove_outliers(iters, losses, times, k: float = 1.5):
    """1.5-IQR filter on losses; keeps >=2 points (fit needs them)."""
    losses = np.asarray(losses, float)
    if len(losses) < 4:
        return list(iters), list(losses), list(times)
    q1, q3 = np.percentile(losses, [25, 75])
    iqr = q3 - q1
    lo, hi = q1 - k * iqr, q3 + k * iqr
    keep = (losses >= lo) & (losses <= hi)
    if keep.sum() < 2:
        return list(iters), list(losses), list(times)
    return ([x for x, kp in zip(iters, keep) if kp],
            [float(x) for x, kp in zip(losses, keep) if kp],
            [x for x, kp in zip(times, keep) if kp])


class MetricsRepository:
    def __init__(self):
        self.records: list[IterationRecord] = []
        self.settings: dict[int, dict] = {}
        self._key_to_id: dict[tuple, int] = {}
        self.windows_list: list[SettingWindow] = []
        self._current: SettingWindow | None = None
        self.reconfig_events: list[dict] = []

    def setting_id(self, setting: dict) -> int:
        k = setting_key(setting)
        if k not in self._key_to_id:
            sid = len(self._key_to_id)
            self._key_to_id[k] = sid
            self.settings[sid] = dict(setting)
        return self._key_to_id[k]

    def begin_window(self, setting: dict, start_loss: float):
        sid = self.setting_id(setting)
        self._current = SettingWindow(sid, dict(setting), start_loss)
        self.windows_list.append(self._current)
        return self._current

    def add(self, j: int, t: float, loss: float):
        assert self._current is not None, "begin_window first"
        self.records.append(IterationRecord(j, self._current.setting_id,
                                            t, loss))
        self._current.iters.append(j)
        self._current.times.append(t)
        self._current.losses.append(loss)

    def add_reconfig(self, kinds: tuple, cost_s: float, method: str):
        self.reconfig_events.append(
            {"kinds": tuple(kinds), "cost_s": float(cost_s), "method": method})

    def windows(self, min_len: int = 2):
        return [w for w in self.windows_list if len(w.iters) >= min_len]

    def clean_window(self, w: SettingWindow):
        return remove_outliers(w.iters, w.losses, w.times)

    @property
    def latest_loss(self) -> float:
        return self.records[-1].loss if self.records else float("inf")

    def rolling_loss(self, k: int = 8) -> float:
        if not self.records:
            return float("inf")
        tail = [r.loss for r in self.records[-k:]]
        return float(np.mean(tail))

    @property
    def total_iterations(self) -> int:
        return len(self.records)

    @property
    def total_time(self) -> float:
        return float(sum(r.t for r in self.records))
