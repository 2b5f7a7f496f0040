"""tinyllama-1.1b — the paper's own decoder-only model (Fig. 7 experiments).
22L d_model=2048 32H (GQA kv=4) d_ff=5632 vocab=32000 [arXiv:2401.02385]."""
from repro_torch.config import ModelConfig
from repro_torch.configs.common import SCALE_WASI, SMOKE_WASI, uniform_groups


def config() -> ModelConfig:
    return ModelConfig(
        name="tinyllama-1.1b", family="lm",
        n_layers=22, d_model=2048, n_heads=32, n_kv_heads=4, d_ff=5632,
        vocab_size=32000, head_dim=64, mlp_act="swiglu", norm="rmsnorm",
        groups=uniform_groups("dense", 22),
        wasi=SCALE_WASI, dtype="bfloat16", remat="block",
        sub_quadratic=False, has_decoder=True)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="tinyllama-smoke", family="lm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=256, head_dim=16, mlp_act="swiglu", norm="rmsnorm",
        groups=uniform_groups("dense", 2),
        wasi=SMOKE_WASI, dtype="float32", remat="none")
