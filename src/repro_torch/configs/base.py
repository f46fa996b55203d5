"""Architecture + run configuration dataclasses (the JAX package's
``configs/base.py``, fields unchanged, so a config reads the same).

``ArchConfig.reduced()`` shrinks every dimension while keeping the family,
for the CPU tests. ``ShapeConfig`` / ``SHAPES`` are the dry run's input
shapes (``launch/dryrun.py``) and ``cell_is_applicable`` says which
(architecture, shape) cells it runs, with the reference's reason for a
skipped one.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Any


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# ---------------------------------------------------------------------------
# Sub-configs
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    d_ff_shared: int = 0
    capacity_factor: float = 1.25
    router: str = "softmax_topk"
    routed_scaling: float = 1.0
    aux_loss_coef: float = 0.0
    start_layer: int = 0
    n_expert_pad: int = 0        # experts padded (masked out) for even sharding
    chunk_tokens: int = 4096     # tokens a dispatch chunk (bounds the buffers)

    @property
    def n_experts_padded(self) -> int:
        return self.n_experts + self.n_expert_pad


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 (SSD) block parameters [arXiv:2405.21060]."""
    d_state: int = 128
    expand: int = 2
    head_dim: int = 64
    chunk: int = 256
    conv_width: int = 4
    n_groups: int = 1

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class RGLRUConfig:
    """Griffin RG-LRU recurrent block parameters [arXiv:2402.19427]."""
    lru_width: int = 0
    conv_width: int = 4
    c: float = 8.0


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek multi-head latent attention [arXiv:2412.19437]."""
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


# ---------------------------------------------------------------------------
# ArchConfig
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                       # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                 # 0 -> d_model // n_heads
    # block pattern: repeating unit of layer kinds
    # kinds: "attn" (full), "local" (windowed), "ssm", "rglru"
    pattern: tuple[str, ...] = ("attn",)
    window: int = 0                   # local attention window
    act: str = "silu"
    gated_mlp: bool = True
    norm: str = "rmsnorm"             # rmsnorm | layernorm | layernorm_np
    rope_theta: float = 10000.0
    pos: str = "rope"                 # rope | sinusoidal | none
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    query_scale: float = 0.0          # 0 -> 1/sqrt(head_dim)
    tie_embeddings: bool = False
    post_block_norm: bool = False     # gemma2-style post-norms
    scale_embedding: bool = False     # gemma-style sqrt(d) embed scale
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    rglru: RGLRUConfig | None = None
    mla: MLAConfig | None = None
    cross_attn: bool = False
    cond_len: int = 64
    prefix_embeds: int = 0
    mtp: bool = False
    cache_seq_shard: bool = False
    dtype: str = "bfloat16"
    optimizer: str = "adamw"
    remat: str = "full"
    sub_quadratic: bool = False
    source: str = ""

    @property
    def dh(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        return round_up(self.vocab, 256)

    @property
    def layer_kinds(self) -> tuple[str, ...]:
        """Per-layer kind list of length n_layers (pattern repeated + truncated)."""
        reps = math.ceil(self.n_layers / len(self.pattern))
        return tuple((self.pattern * reps)[: self.n_layers])

    def n_params(self) -> int:
        """Analytic parameter count (embeddings excluded)."""
        from repro_torch.models.model import count_params_analytic
        return count_params_analytic(self)

    def n_params_active(self) -> int:
        """``n_params`` with each MoE expert tensor counted at ``top_k /
        n_experts`` (the parameters a token runs through)."""
        from repro_torch.models.model import count_params_analytic
        return count_params_analytic(self, active_only=True)

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU tests."""
        unit = len(self.pattern)
        n_layers = max(unit, 2 if unit == 1 else unit)
        kw: dict[str, Any] = dict(
            n_layers=n_layers,
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab=256,
            window=min(self.window, 32) if self.window else 0,
            cond_len=8 if self.cross_attn else self.cond_len,
            prefix_embeds=4 if self.prefix_embeds else 0,
        )
        if self.moe is not None:
            kw["moe"] = replace(
                self.moe, n_experts=8, top_k=2, d_ff_expert=32,
                d_ff_shared=32 if self.moe.n_shared else 0,
                start_layer=min(self.moe.start_layer, 1),
                n_expert_pad=0, chunk_tokens=64,
            )
        if self.ssm is not None:
            kw["ssm"] = replace(self.ssm, d_state=16, head_dim=16, chunk=16)
        if self.rglru is not None:
            kw["rglru"] = replace(self.rglru, lru_width=64)
        if self.mla is not None:
            kw["mla"] = MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                                  rope_head_dim=8, nope_head_dim=16, v_head_dim=16)
            kw["head_dim"] = 0
        return replace(self, **kw)


# ---------------------------------------------------------------------------
# Input shapes (the dry run's cells)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                 # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def cell_is_applicable(cfg: ArchConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Whether (arch, shape) is a live dry-run cell; reason if skipped (the
    reference's text, word for word)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("full-attention arch: 0.5M-token context is quadratic and the "
                       "KV cache alone exceeds sane HBM; run only for SSM/hybrid archs "
                       "(see DESIGN.md §5)")
    return True, ""


@dataclass(frozen=True)
class RunConfig:
    """Training/serving hyper-parameters independent of the architecture:
    the JAX ``RunConfig``'s fields, with its defaults."""
    arch: str = "tinyllama-1.1b"
    shape: str = "train_4k"
    # paper-technique knobs (the "stock Hadoop" baseline turns all of these off)
    bucketed_updates: bool = True        # JNI-buffering analogue
    bucket_bytes: int = 1 << 28
    compress_grads: bool = False         # LZO analogue (int8 + error feedback)
    compress_moe_a2a: bool = False       # LZO on the shuffle
    hierarchical_sync: bool = True       # shared-memory-vs-TCP analogue
    donate_state: bool = True            # direct-I/O analogue
    pod_param_mode: str = "sharded"      # replicated (pure DP over pods) | sharded
    remat: str = "full"                  # none | full | dots
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    warmup_steps: int = 100
    steps: int = 200
    microbatch: int = 0                  # 0 = no grad accumulation
    seed: int = 0
    attention_impl: str = "masked"       # masked | blocked_causal
    attn_chunk: int = 1024

    def attention_impl_for(self, seq_len: int) -> str:
        """Pick the attention inner loop for a sequence length.

        ``masked`` materializes S^2 scores, so it is only safe for short
        sequences; both long-seq paths bound memory at [.., S, chunk] per
        step. On the card, causal self attention runs the flash kernel
        whatever this returns (``models/attention.py``).
        """
        if self.attention_impl == "blocked_causal" and seq_len > self.attn_chunk:
            return "blocked_causal"
        if seq_len > self.attn_chunk:
            return "chunked"
        return "masked"

    def paper_faithful(self) -> "RunConfig":
        """The 'stock' baseline: every optimization off (paper's starting
        point)."""
        return replace(
            self, bucketed_updates=False, compress_grads=False,
            compress_moe_a2a=False, hierarchical_sync=False,
            donate_state=False)
