"""Configuration system: typed dataclasses + registry.

A copy of ``repro.config`` (the JAX package), kept field for field so a
``ModelConfig`` means the same model in both packages and a plan's JSON
written by one reads in the other. Every ported architecture is a
``ModelConfig`` built by a module under ``repro_torch/configs``;
``repro_torch.configs.get(name)`` resolves ``--arch <id>``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Literal

BlockKind = Literal[
    "dense",        # attn + MLP (standard decoder block)
    "local",        # sliding-window attn + MLP
    "moe",          # attn + MoE FFN
    "moe_swa",      # sliding-window attn + MoE FFN (mixtral)
    "mamba1",       # Mamba-1 selective-scan block
    "mamba2",       # Mamba-2 SSD block
    "mamba2_attn",  # Mamba-2 block followed by the shared attention block (zamba2)
    "enc",          # bidirectional attn + MLP (encoder)
    "dec",          # causal self-attn + cross-attn + MLP (decoder)
]


@dataclass(frozen=True)
class AsiConfig:
    """Activation Subspace Iteration (paper Alg. 2) knobs."""

    # per-mode rank fractions for (batch, token, feature[, extra]) modes
    batch_frac: float = 1.0     # 1.0 => identity (DP-sharding friendly)
    token_frac: float = 0.25
    feature_frac: float = 0.25
    align: int = 8
    skip_batch: bool = True     # never couple samples across DP shards
    # frozen=True skips the per-step power iteration and only PROJECTS onto
    # the existing factors — the steady-state step when the subspace refresh
    # is amortized every cfg.wasi.refresh_every steps from the host loop
    # (paper runs the iteration every step; EXPERIMENTS.md §Perf iter. 9)
    frozen: bool = False


@dataclass(frozen=True)
class WasiConfig:
    """Weight-Activation Subspace Iteration (the paper's method).

    method: "none"  — vanilla dense training
            "wasi"  — factored weights + ASI-compressed residuals (the paper)
            "asi"   — dense weights + ASI-compressed residuals (ASI baseline)
            "wsi"   — factored weights only (WSI ablation)
    """

    method: Literal["none", "wasi", "asi", "wsi"] = "none"
    scope: Literal["none", "mlp", "all"] = "all"   # which linears get factored
    # paper knob (explained variance). Used by calibration + paper-scale runs.
    epsilon: float = 0.9
    # scale knob: static rank fraction of min(O, I); eps->frac calibrated offline
    rank_frac: float = 0.25
    rank_align: int = 128       # MXU lane alignment (DESIGN.md §3.2)
    min_rank: int = 8
    update_mode: Literal["factored", "project"] = "factored"
    refresh_every: int = 64     # WSI re-orthogonalization period (factored mode)
    asi: AsiConfig = field(default_factory=AsiConfig)

    @property
    def factored(self) -> bool:
        """Parameters ARE the factors (scale branch)."""
        return self.method in ("wasi", "wsi") and self.update_mode == "factored"

    @property
    def project(self) -> bool:
        """Paper-faithful Eq. 9-11: dense W param + per-step WSI extraction."""
        return self.method in ("wasi", "wsi") and self.update_mode == "project"

    @property
    def compress_acts(self) -> bool:
        """Saved-for-backward activations Tucker-compressed?"""
        return self.method in ("wasi", "asi")


@dataclass(frozen=True)
class MoeConfig:
    n_experts: int = 0
    top_k: int = 2
    n_shared: int = 0           # deepseek-style always-on shared experts
    expert_d_ff: int = 0        # per-expert hidden dim (fine-grained MoE)
    capacity_factor: float = 1.25
    shard: Literal["expert", "ffn"] = "expert"   # EP vs TP sharding of experts


@dataclass(frozen=True)
class SsmConfig:
    d_state: int = 16
    expand: int = 2
    d_conv: int = 4
    head_dim: int = 64          # mamba2 only
    chunk: int = 256            # SSD chunk length
    dt_rank: int = 0            # mamba1: 0 => d_model // 16


@dataclass(frozen=True)
class LayerGroup:
    """A repeated pattern of block kinds, scanned over ``repeat``.

    Scan-over-groups keeps HLO size independent of depth; heterogeneous
    stacks (gemma3 5:1, zamba2 shared-attn interleave) become homogeneous at
    group granularity (DESIGN.md §6).
    """

    pattern: tuple[BlockKind, ...]
    repeat: int


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Literal["lm", "encdec", "vit"] = "lm"
    n_layers: int = 12
    d_model: int = 768
    n_heads: int = 12
    n_kv_heads: int = 12
    d_ff: int = 3072
    vocab_size: int = 32000
    head_dim: int = 0           # 0 => d_model // n_heads
    groups: tuple[LayerGroup, ...] = ()
    # attention
    rope_theta: float = 10000.0
    qkv_bias: bool = False
    window: int = 4096          # sliding-window size for local/SWA blocks
    mlp_act: Literal["gelu", "swiglu"] = "swiglu"
    tie_embeddings: bool = False
    norm: Literal["rmsnorm", "layernorm"] = "rmsnorm"
    # encoder-decoder
    n_enc_layers: int = 0
    enc_seq: int = 0            # fixed encoder memory length (whisper: 1500)
    # subconfigs
    moe: MoeConfig = field(default_factory=MoeConfig)
    ssm: SsmConfig = field(default_factory=SsmConfig)
    wasi: WasiConfig = field(default_factory=WasiConfig)
    # numerics / memory
    dtype: str = "bfloat16"
    remat: Literal["none", "block"] = "block"
    logit_softcap: float = 0.0
    max_seq: int = 131072
    # metadata
    sub_quadratic: bool = False   # eligible for long_500k
    has_decoder: bool = True      # False => skip decode shapes

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        """Embedding/lm_head table size: vocab rounded up to a multiple of
        256 so the vocab dim shards evenly on any production mesh axis
        (standard practice; logical vocab_size is unchanged — labels and
        sampling never touch the pad rows)."""
        return -(-self.vocab_size // 256) * 256

    @property
    def total_pattern_layers(self) -> int:
        return sum(len(g.pattern) * g.repeat for g in self.groups)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclass(frozen=True)
class TrainConfig:
    """Paper §B.1 recipe + scale knobs."""

    optimizer: Literal["sgd", "adamw"] = "sgd"
    lr: float = 0.05
    momentum: float = 0.0
    weight_decay: float = 1e-4
    clip_norm: float = 2.0
    schedule: Literal["cosine", "constant"] = "cosine"
    steps: int = 1000
    warmup: int = 0
    seed: int = 233             # paper §B.2 fixes seed 233
    microbatch: int = 0         # 0 => no gradient accumulation
    powersgd_rank: int = 0      # 0 => no DP gradient compression of dense params
    checkpoint_every: int = 100
    checkpoint_dir: str = "/tmp/repro_ckpt"
    keep_checkpoints: int = 3
