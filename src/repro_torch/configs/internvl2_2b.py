"""internvl2-2b — InternViT + InternLM2 [arXiv:2404.16821].

Backbone (InternLM2-1.8B): 24L, d_model=2048, 16 heads (GQA kv=8, head_dim=128),
d_ff=8192 (SwiGLU), vocab=92553. The InternViT frontend is a stub: the caller passes
256 precomputed patch embeddings (``batch["prefix"] [B, 256, d_model]``), which take
the place of the first 256 token embeddings.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab=92553,
    pattern=("attn",),
    act="silu",
    gated_mlp=True,
    norm="rmsnorm",
    rope_theta=1000000.0,
    prefix_embeds=256,
    # the decode cache's positions are cut over the model axis, not its head
    # dim (models/attention.py::cache_cut), as the reference prefers
    cache_seq_shard=True,
    source="arXiv:2404.16821",
)
