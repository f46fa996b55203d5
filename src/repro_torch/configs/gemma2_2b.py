"""gemma2-2b — local+global alternating attention, logit softcapping [arXiv:2408.00118].

26L, d_model=2304, 8 heads (GQA kv=4, head_dim=256), d_ff=9216 (GeGLU), vocab=256000.
Even layers use a 4096-token sliding window; odd layers are global. Attention logits
soft-capped at 50, final logits at 30; query scale 1/sqrt(256); sqrt(d) embed scaling;
post-block RMSNorms.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-2b",
    family="dense",
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab=256000,
    pattern=("local", "attn"),
    window=4096,
    act="gelu",
    gated_mlp=True,
    norm="rmsnorm",
    rope_theta=10000.0,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    query_scale=1.0 / 16.0,      # 1/sqrt(256)
    scale_embedding=True,
    post_block_norm=True,
    tie_embeddings=True,
    source="arXiv:2408.00118",
)
