from repro_torch.configs.base import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.configs.registry import ARCHS, get_config

__all__ = ["ModelConfig", "ShapeConfig", "TrainConfig", "ARCHS", "get_config"]
