"""Dense feed-forward blocks (gated and plain): the JAX package's
``models/ffn.py``."""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.core.device import resolve_device
from repro_torch.models.common import activate, einsum
from repro_torch.models.params import ParamDef, ParamModule


def ffn_schema(cfg: ArchConfig, d_ff: int | None = None) -> dict:
    D = cfg.d_model
    F = d_ff if d_ff is not None else cfg.d_ff
    s = {
        "w_up": ParamDef((D, F), ("embed", "mlp")),
        "w_down": ParamDef((F, D), ("mlp", "embed")),
    }
    if cfg.gated_mlp:
        s["w_gate"] = ParamDef((D, F), ("embed", "mlp"))
    return s


def ffn_apply(cfg: ArchConfig, p, x):
    h = einsum("bsd,df->bsf", x, p["w_up"])
    if cfg.gated_mlp:
        g = einsum("bsd,df->bsf", x, p["w_gate"])
        h = activate(cfg.act, g) * h
    else:
        h = activate(cfg.act, h)
    return einsum("bsf,fd->bsd", h, p["w_down"])


class FFN(ParamModule):
    """``w_up [D,F]``, ``w_gate [D,F]`` (gated), ``w_down [F,D]``."""

    def __init__(self, cfg: ArchConfig, *, device=None, dtype=None):
        super().__init__(ffn_schema(cfg), device=resolve_device(device),
                         dtype=dtype)
        self.cfg = cfg

    def forward(self, x):
        return ffn_apply(self.cfg, self, x)
