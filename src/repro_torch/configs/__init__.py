"""Config registry: ``get_config("<arch-id>")`` + shape registry."""
from repro_torch.configs.base import ModelConfig, ShapeConfig, INPUT_SHAPES
from repro_torch.configs.registry import ARCH_IDS, get_config, all_configs
