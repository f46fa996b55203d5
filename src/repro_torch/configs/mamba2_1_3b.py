"""mamba2-1.3b — SSD (state-space duality) [arXiv:2405.21060].

48 blocks, d_model=2048, attention-free, d_ff=0 (Mamba-2 blocks only), vocab=50280,
ssm_state=128. expand=2 -> d_inner=4096, head_dim=64 -> 64 SSD heads.
"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=64,            # SSD heads = d_inner / head_dim
    n_kv_heads=64,
    d_ff=0,                # no separate MLP: the Mamba block is the whole layer
    vocab=50280,
    pattern=("ssm",),
    ssm=SSMConfig(d_state=128, expand=2, head_dim=64, chunk=256, conv_width=4),
    norm="rmsnorm",
    pos="none",
    tie_embeddings=True,
    sub_quadratic=True,
    source="arXiv:2405.21060",
)
