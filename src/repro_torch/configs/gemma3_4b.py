"""gemma3-4b [dense] 34L d_model=2560 8H (GQA kv=4) d_ff=10240 vocab=262144
— 5:1 local:global, 128k context [hf:google/gemma-3-1b-pt; unverified]."""
from repro_torch.config import ModelConfig
from repro_torch.configs.common import SCALE_WASI, SMOKE_WASI, patterned_groups


def config() -> ModelConfig:
    # 34 layers = 5 groups of (5 local + 1 global) + 4 local tail
    return ModelConfig(
        name="gemma3-4b", family="lm",
        n_layers=34, d_model=2560, n_heads=8, n_kv_heads=4, d_ff=10240,
        vocab_size=262144, head_dim=256, window=1024, tie_embeddings=True,
        mlp_act="swiglu", norm="rmsnorm", rope_theta=1e6, logit_softcap=30.0,
        groups=patterned_groups(("local",) * 5 + ("dense",), 5,
                                tail=("local",) * 4),
        wasi=SCALE_WASI, dtype="bfloat16", remat="block",
        sub_quadratic=True,  # 5:1 local:global — long_500k runs (DESIGN §5)
        has_decoder=True)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-smoke", family="lm",
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=256, head_dim=16, window=8, tie_embeddings=True,
        mlp_act="swiglu", norm="rmsnorm", logit_softcap=30.0,
        groups=patterned_groups(("local", "local", "dense"), 1),
        wasi=SMOKE_WASI, dtype="float32", remat="none", sub_quadratic=True)
