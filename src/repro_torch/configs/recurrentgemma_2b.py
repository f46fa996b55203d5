"""recurrentgemma-2b — RG-LRU + local attention, 2 recurrent : 1 attention [arXiv:2402.19427].

26L, d_model=2560, 10 heads (MQA kv=1, head_dim=256), d_ff=7680 (GeGLU), vocab=256000,
lru_width=2560, local window 2048. Pattern unit (rglru, rglru, local).
"""
from repro_torch.configs.base import ArchConfig, RGLRUConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,               # 8 full (r,r,a) units + (r,r)
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab=256000,
    pattern=("rglru", "rglru", "local"),
    window=2048,
    act="gelu",
    gated_mlp=True,
    norm="rmsnorm",
    rope_theta=10000.0,
    rglru=RGLRUConfig(lru_width=2560, conv_width=4, c=8.0),
    scale_embedding=True,
    tie_embeddings=True,
    sub_quadratic=True,        # recurrence + bounded-window attention
    source="arXiv:2402.19427",
)
