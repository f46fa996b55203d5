"""Registry of the architectures the port runs (``--arch <id>``).

Six of the JAX package's ten architectures are ported: the dense
``tinyllama-1.1b``, ``olmo-1b``, ``starcoder2-7b`` and ``gemma2-2b``, the
hybrid ``recurrentgemma-2b`` (RG-LRU) and the SSM ``mamba2-1.3b`` (SSD).
The other four need modules the port does not have yet: MoE, MLA and MTP
(deepseek-v3, granite-moe: ROADMAP queue 1 item 1), cross attention and
prefix embeds (musicgen, internvl2: item 2).
"""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.gemma2_2b import CONFIG as _gemma2
from repro_torch.configs.mamba2_1_3b import CONFIG as _mamba2
from repro_torch.configs.olmo_1b import CONFIG as _olmo
from repro_torch.configs.recurrentgemma_2b import CONFIG as _recurrentgemma
from repro_torch.configs.starcoder2_7b import CONFIG as _starcoder2
from repro_torch.configs.tinyllama_1_1b import CONFIG as _tinyllama

ARCHS: dict[str, ArchConfig] = {
    c.name: c for c in (_tinyllama, _olmo, _starcoder2, _gemma2,
                        _recurrentgemma, _mamba2)}

# the ROADMAP queue 1 item that holds each architecture still unported
NOT_PORTED = {"deepseek-v3-671b": 1, "granite-moe-3b-a800m": 1,
              "internvl2-2b": 2, "musicgen-medium": 2}


def get_arch(name: str) -> ArchConfig:
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"arch {name!r} is not ported to PyTorch yet (ROADMAP queue 1 "
            f"item {NOT_PORTED[name]}); ported: {sorted(ARCHS)}")
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]
