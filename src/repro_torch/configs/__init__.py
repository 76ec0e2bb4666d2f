from repro_torch.configs.base import (
    ModelConfig, ShapeConfig, SHAPES, register, get_config, smoke_config,
    list_configs, applicable_shapes,
)

__all__ = [
    "ModelConfig", "ShapeConfig", "SHAPES", "register", "get_config",
    "smoke_config", "list_configs", "applicable_shapes",
]
