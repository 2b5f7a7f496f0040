"""stablelm-3b [dense] 32L d_model=2560 32H (GQA kv=32) d_ff=6912
vocab=50304 [hf:stabilityai/stablelm-2-1_6b; unverified]."""
from repro_torch.config import ModelConfig
from repro_torch.configs.common import SCALE_WASI, SMOKE_WASI, uniform_groups


def config() -> ModelConfig:
    return ModelConfig(
        name="stablelm-3b", family="lm",
        n_layers=32, d_model=2560, n_heads=32, n_kv_heads=32, d_ff=6912,
        vocab_size=50304, head_dim=80, mlp_act="swiglu", norm="layernorm",
        groups=uniform_groups("dense", 32),
        wasi=SCALE_WASI, dtype="bfloat16", remat="block",
        sub_quadratic=False, has_decoder=True)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="stablelm-smoke", family="lm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=160,
        vocab_size=256, head_dim=16, mlp_act="swiglu", norm="layernorm",
        groups=uniform_groups("dense", 2),
        wasi=SMOKE_WASI, dtype="float32", remat="none")
