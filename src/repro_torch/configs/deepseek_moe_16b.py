"""deepseek-moe-16b [moe] 28L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=102400 — 2 shared + 64 routed top-6, fine-grained; dense layer 0
(d_ff 10944) [arXiv:2401.06066; hf].

Layer 0 is a ``dense`` block (attention + MLP at ``d_ff``); the other 27
are ``moe``: causal full attention, then 64 routed experts (top 6) and 2
always-on shared experts at ``expert_d_ff`` (``nn/moe.py``). Every layer
is causal full attention, so it serves from a paged KV pool too."""
from repro_torch.config import LayerGroup, ModelConfig, MoeConfig
from repro_torch.configs.common import SCALE_WASI, SMOKE_WASI


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-16b", family="lm",
        n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=10944,
        vocab_size=102400, head_dim=128, mlp_act="swiglu", norm="rmsnorm",
        groups=(LayerGroup(pattern=("dense",), repeat=1),
                LayerGroup(pattern=("moe",), repeat=27)),
        moe=MoeConfig(n_experts=64, top_k=6, n_shared=2, expert_d_ff=1408,
                      capacity_factor=1.25, shard="expert"),
        wasi=SCALE_WASI, dtype="bfloat16", remat="block",
        sub_quadratic=False, has_decoder=True)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-smoke", family="lm",
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=160,
        vocab_size=256, head_dim=16, mlp_act="swiglu", norm="rmsnorm",
        groups=(LayerGroup(pattern=("dense",), repeat=1),
                LayerGroup(pattern=("moe",), repeat=2)),
        moe=MoeConfig(n_experts=8, top_k=2, n_shared=1, expert_d_ff=32,
                      capacity_factor=2.0, shard="expert"),
        wasi=SMOKE_WASI, dtype="float32", remat="none")
