"""mixtral-8x7b [moe] 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000
— MoE 8 experts top-2, sliding-window attention [arXiv:2401.04088; hf].

Every layer is ``moe_swa``: attention over a 4,096-key window, then the
routed expert FFN (``nn/moe.py``); no dense MLP site. The window rules a
paged KV pool out (``models.lm.supports_paging``)."""
from repro_torch.config import ModelConfig, MoeConfig
from repro_torch.configs.common import SCALE_WASI, SMOKE_WASI, uniform_groups


def config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x7b", family="lm",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
        vocab_size=32000, head_dim=128, window=4096,
        mlp_act="swiglu", norm="rmsnorm", rope_theta=1e6,
        groups=uniform_groups("moe_swa", 32),
        moe=MoeConfig(n_experts=8, top_k=2, expert_d_ff=14336,
                      capacity_factor=1.25, shard="ffn"),
        wasi=SCALE_WASI, dtype="bfloat16", remat="block",
        sub_quadratic=True,  # SWA — long_500k runs
        has_decoder=True)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-smoke", family="lm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=256, head_dim=16, window=8,
        mlp_act="swiglu", norm="rmsnorm",
        groups=uniform_groups("moe_swa", 2),
        moe=MoeConfig(n_experts=4, top_k=2, expert_d_ff=128,
                      capacity_factor=2.0, shard="ffn"),
        wasi=SMOKE_WASI, dtype="float32", remat="none", sub_quadratic=True)
