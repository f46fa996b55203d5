"""Registry of the architectures the port runs (``--arch <id>``).

Only the dense ``tinyllama-1.1b`` is ported. The JAX package's other
architectures need modules the port does not have yet (gemma2's local
attention, softcaps, post-norms and tied head; MoE; SSM; RG-LRU; MLA;
cross-attention; prefix embeds): ROADMAP queue 1 item 3.
"""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.tinyllama_1_1b import CONFIG as _tinyllama

ARCHS: dict[str, ArchConfig] = {_tinyllama.name: _tinyllama}

NOT_PORTED = ("deepseek-v3-671b", "gemma2-2b", "granite-moe-3b-a800m",
              "internvl2-2b", "mamba2-1.3b", "musicgen-medium", "olmo-1b",
              "recurrentgemma-2b", "starcoder2-7b")


def get_arch(name: str) -> ArchConfig:
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"arch {name!r} is not ported to PyTorch yet (ROADMAP queue 1 "
            f"item 3); ported: {sorted(ARCHS)}")
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]
