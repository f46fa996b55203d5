"""olmo-1b — non-parametric LayerNorm [arXiv:2402.00838].

16L, d_model=2048, 16 heads (MHA: kv=16), d_ff=8192 (SwiGLU), vocab=50304.
OLMo's LayerNorm carries no learnable scale/bias (norm="layernorm_np").
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="olmo-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab=50304,
    pattern=("attn",),
    act="silu",
    gated_mlp=True,
    norm="layernorm_np",
    rope_theta=10000.0,
    tie_embeddings=True,
    source="arXiv:2402.00838",
)
