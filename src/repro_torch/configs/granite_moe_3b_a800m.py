"""granite-moe-3b-a800m — 40 experts top-8 [hf:ibm-granite/granite-3.0-3b-a800m-base].

32L, d_model=1536, 24 heads (GQA kv=8, head_dim=64), expert d_ff=512 (SwiGLU),
vocab=49155, MoE 40 experts top-8 on every layer. Experts padded 40->48 so the expert
axis shards evenly over model=16 (8 masked experts the router can never select).
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab=49155,
    pattern=("attn",),
    act="silu",
    gated_mlp=True,
    norm="rmsnorm",
    rope_theta=10000.0,
    moe=MoEConfig(
        n_experts=40, top_k=8, d_ff_expert=512,
        router="softmax_topk", aux_loss_coef=0.01,
        capacity_factor=1.25, n_expert_pad=8, chunk_tokens=4096,
    ),
    tie_embeddings=True,
    source="hf:ibm-granite/granite-3.0-3b-a800m-base",
)
