from repro_torch.configs.base import (SHAPES, ArchConfig, MLAConfig,
                                      MoEConfig, RGLRUConfig, RunConfig,
                                      ShapeConfig, SSMConfig,
                                      cell_is_applicable, round_up)
from repro_torch.configs.registry import (ARCHS, get_arch, get_shape,
                                          live_cells)
