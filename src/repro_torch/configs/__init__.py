"""Architecture configs (10 assigned + reduced smoke variants) and shapes."""
from repro_torch.configs.base import (ArchConfig, HybridConfig, LM_SHAPES,
                                      MoEConfig, RwkvConfig, ShapeCell,
                                      SSMConfig, applicable_shapes)

__all__ = ["ArchConfig", "HybridConfig", "LM_SHAPES", "MoEConfig",
           "RwkvConfig", "ShapeCell", "SSMConfig", "applicable_shapes"]
