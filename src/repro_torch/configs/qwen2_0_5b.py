"""qwen2-0.5b [dense] 24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151936
— GQA, QKV bias [arXiv:2407.10671; hf]."""
from repro_torch.config import ModelConfig
from repro_torch.configs.common import SCALE_WASI, SMOKE_WASI, uniform_groups


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-0.5b", family="lm",
        n_layers=24, d_model=896, n_heads=14, n_kv_heads=2, d_ff=4864,
        vocab_size=151936, head_dim=64, qkv_bias=True, tie_embeddings=True,
        rope_theta=1e6, mlp_act="swiglu", norm="rmsnorm",
        groups=uniform_groups("dense", 24),
        wasi=SCALE_WASI, dtype="bfloat16", remat="block",
        sub_quadratic=False, has_decoder=True)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-smoke", family="lm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=256, head_dim=16, qkv_bias=True, tie_embeddings=True,
        mlp_act="swiglu", norm="rmsnorm",
        groups=uniform_groups("dense", 2),
        wasi=SMOKE_WASI, dtype="float32", remat="none")
