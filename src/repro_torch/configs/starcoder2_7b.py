"""starcoder2-7b — GQA + RoPE [arXiv:2402.19173].

32L, d_model=4608, 36 heads (GQA kv=4, head_dim=128), d_ff=18432 (plain GELU MLP),
vocab=49152, LayerNorm.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-7b",
    family="dense",
    n_layers=32,
    d_model=4608,
    n_heads=36,
    n_kv_heads=4,
    head_dim=128,
    d_ff=18432,
    vocab=49152,
    pattern=("attn",),
    act="gelu",
    gated_mlp=False,
    norm="layernorm",
    rope_theta=100000.0,
    source="arXiv:2402.19173",
)
