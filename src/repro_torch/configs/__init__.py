from repro_torch.configs.base import (ArchConfig, MLAConfig, MoEConfig,
                                      RGLRUConfig, RunConfig, SSMConfig,
                                      round_up)
from repro_torch.configs.registry import ARCHS, get_arch
