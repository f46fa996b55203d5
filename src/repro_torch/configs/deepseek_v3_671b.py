"""deepseek-v3-671b — MLA, 1 shared + 256 routed top-8 MoE, MTP [arXiv:2412.19437].

61L, d_model=7168, 128 heads (MLA: q_lora=1536, kv_lora=512, rope=64, nope=128, v=128),
routed expert d_ff=2048, vocab=129280. First 3 layers dense (d_ff=18432); aux-loss-free
sigmoid+bias routing with routed_scaling=2.5; one shared expert; optional depth-1 MTP.
Optimizer defaults to Adafactor so 671B of optimizer state fits 512 chips of HBM.
"""
from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=18432,               # dense FFN width for the first `start_layer` layers
    vocab=129280,
    pattern=("attn",),
    act="silu",
    gated_mlp=True,
    norm="rmsnorm",
    rope_theta=10000.0,
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  rope_head_dim=64, nope_head_dim=128, v_head_dim=128),
    moe=MoEConfig(
        n_experts=256, top_k=8, d_ff_expert=2048,
        n_shared=1, d_ff_shared=2048,
        router="sigmoid_bias", routed_scaling=2.5,
        start_layer=3, capacity_factor=1.25, chunk_tokens=2048,
    ),
    mtp=True,
    optimizer="adafactor",
    source="arXiv:2412.19437",
)
