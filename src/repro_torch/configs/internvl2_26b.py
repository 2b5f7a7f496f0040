"""internvl2-26b [vlm] 48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92553 — InternViT + InternLM2 [arXiv:2404.16821; hf].

Backbone only; the ViT frontend is a STUB: input_specs supplies precomputed
patch embeddings (B, S, d) consumed directly by lm_forward."""
from repro_torch.config import ModelConfig
from repro_torch.configs.common import SCALE_WASI, SMOKE_WASI, uniform_groups


def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-26b", family="lm",
        n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=16384,
        vocab_size=92553, head_dim=128, mlp_act="swiglu", norm="rmsnorm",
        groups=uniform_groups("dense", 48),
        wasi=SCALE_WASI, dtype="bfloat16", remat="block",
        sub_quadratic=False, has_decoder=True)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-smoke", family="lm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=160,
        vocab_size=256, head_dim=16, mlp_act="swiglu", norm="rmsnorm",
        groups=uniform_groups("dense", 2),
        wasi=SMOKE_WASI, dtype="float32", remat="none")
