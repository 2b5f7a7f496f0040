"""granite-3-8b [dense] 40L d_model=4096 32H (GQA kv=8) d_ff=12800
vocab=49155 — GQA [hf:ibm-granite/granite-3.0-2b-base; hf]."""
from repro_torch.config import ModelConfig
from repro_torch.configs.common import SCALE_WASI, SMOKE_WASI, uniform_groups


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-3-8b", family="lm",
        n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=12800,
        vocab_size=49155, head_dim=128, mlp_act="swiglu", norm="rmsnorm",
        rope_theta=1e7,
        groups=uniform_groups("dense", 40),
        wasi=SCALE_WASI, dtype="bfloat16", remat="block",
        sub_quadratic=False, has_decoder=True)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="granite-smoke", family="lm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=160,
        vocab_size=256, head_dim=16, mlp_act="swiglu", norm="rmsnorm",
        groups=uniform_groups("dense", 2),
        wasi=SMOKE_WASI, dtype="float32", remat="none")
