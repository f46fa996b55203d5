"""tinyllama-1.1b — llama2-arch small [arXiv:2401.02385].

22L, d_model=2048, 32 heads (GQA kv=4), d_ff=5632 (SwiGLU), vocab=32000.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="tinyllama-1.1b",
    family="dense",
    n_layers=22,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_ff=5632,
    vocab=32000,
    pattern=("attn",),
    act="silu",
    gated_mlp=True,
    norm="rmsnorm",
    rope_theta=10000.0,
    source="arXiv:2401.02385",
)
