"""musicgen-medium — decoder-only over EnCodec tokens [arXiv:2306.05284].

48L, d_model=1536, 24 heads (MHA kv=24), d_ff=6144 (GELU), vocab=2048.
Backbone only: the EnCodec/T5 frontend is a stub, and the caller passes
precomputed conditioning embeddings (``batch["cond"] [B, cond_len, d_model]``),
which every layer's cross attention reads.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    d_ff=6144,
    vocab=2048,
    pattern=("attn",),
    act="gelu",
    gated_mlp=False,
    norm="layernorm",
    pos="sinusoidal",
    cross_attn=True,
    cond_len=64,
    source="arXiv:2306.05284",
)
