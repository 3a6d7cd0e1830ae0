from .base import (INPUT_SHAPES, LoRAConfig, ModelConfig, MoEConfig,  # noqa: F401
                   ShapeConfig, SSMConfig)
from .registry import get_config, list_archs  # noqa: F401
