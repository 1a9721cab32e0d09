"""Configurations the port runs: the paper's simulated SSD, and the model
architectures of the serving path (copies of the reference's
`repro/configs`; `models.model_zoo.build_model` says which families the
port can run yet)."""
from repro_torch.configs.base import (ArchConfig, EncDecConfig, HybridConfig,
                                      MLAConfig, MoEConfig, SHAPES,
                                      SHAPES_BY_NAME, ShapeConfig, SSMConfig,
                                      VLMConfig, shape_applicable)
from repro_torch.configs.registry import (ARCH_IDS, ARCHS, dryrun_cells,
                                          get_arch, get_shape)

__all__ = [
    "ArchConfig", "EncDecConfig", "HybridConfig", "MLAConfig", "MoEConfig",
    "SHAPES", "SHAPES_BY_NAME", "ShapeConfig", "SSMConfig", "VLMConfig",
    "shape_applicable", "ARCH_IDS", "ARCHS", "dryrun_cells", "get_arch",
    "get_shape",
]
