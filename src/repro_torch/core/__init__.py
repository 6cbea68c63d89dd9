"""Knob spaces and the bounded cache of step callables."""
from repro_torch.core.knobs import Knob, KnobSpace, setting_key
from repro_torch.core.lru import LRUCache

__all__ = ["Knob", "KnobSpace", "setting_key", "LRUCache"]
