"""Registry of the architectures the port runs (``--arch <id>``).

All ten of the JAX package's architectures are ported: the dense
``tinyllama-1.1b``, ``olmo-1b``, ``starcoder2-7b`` and ``gemma2-2b``, the
hybrid ``recurrentgemma-2b`` (RG-LRU), the SSM ``mamba2-1.3b`` (SSD), the
mixtures of experts ``granite-moe-3b-a800m`` (softmax top-8 of 40 experts
padded to 48) and ``deepseek-v3-671b`` (MLA, 3 dense layers, then
sigmoid+bias top-8 of 256 experts and a shared one; its MTP parameters are
carried, its MTP loss is training), the audio decoder ``musicgen-medium``
(sinusoidal positions, cross attention to ``cond``) and the VLM backbone
``internvl2-2b`` (patch embeddings as a ``prefix``). On the CPU run them at
``get_arch(name).reduced()`` with ``device="cpu"``; on the card at their
published widths (``chip_smoke.py``, ``scripts/torch_lm_profile.py
--arch``; deepseek-v3 with its depth cut, ``--layers``).
"""
from __future__ import annotations

from repro_torch.configs.base import (SHAPES, ArchConfig, ShapeConfig,
                                      cell_is_applicable)
from repro_torch.configs.deepseek_v3_671b import CONFIG as _deepseek
from repro_torch.configs.gemma2_2b import CONFIG as _gemma2
from repro_torch.configs.granite_moe_3b_a800m import CONFIG as _granite
from repro_torch.configs.internvl2_2b import CONFIG as _internvl2
from repro_torch.configs.mamba2_1_3b import CONFIG as _mamba2
from repro_torch.configs.musicgen_medium import CONFIG as _musicgen
from repro_torch.configs.olmo_1b import CONFIG as _olmo
from repro_torch.configs.recurrentgemma_2b import CONFIG as _recurrentgemma
from repro_torch.configs.starcoder2_7b import CONFIG as _starcoder2
from repro_torch.configs.tinyllama_1_1b import CONFIG as _tinyllama

ARCHS: dict[str, ArchConfig] = {
    c.name: c for c in (_tinyllama, _olmo, _starcoder2, _gemma2,
                        _recurrentgemma, _mamba2, _granite, _deepseek,
                        _musicgen, _internvl2)}

# the ROADMAP queue 1 item that holds each architecture still unported
NOT_PORTED: dict[str, int] = {}


def get_arch(name: str) -> ArchConfig:
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"arch {name!r} is not ported to PyTorch yet (ROADMAP queue 1 "
            f"item {NOT_PORTED[name]}); ported: {sorted(ARCHS)}")
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; known: {sorted(SHAPES)}")
    return SHAPES[name]


def live_cells() -> list[tuple[ArchConfig, ShapeConfig]]:
    """All applicable (arch, shape) dry-run cells, in ``ARCHS`` order."""
    return [(cfg, shape) for cfg in ARCHS.values()
            for shape in SHAPES.values()
            if cell_is_applicable(cfg, shape)[0]]
