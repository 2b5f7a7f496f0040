"""zamba2-7b [hybrid] 81L d_model=3584 32H (GQA kv=32) d_ff=14336
vocab=32000 ssm_state=64 — Mamba2 + shared attn blocks
[arXiv:2411.15242; unverified].

81 mamba2 layers; a SHARED transformer block (attn+MLP, one weight copy)
fires after every 6th mamba2 layer: 13 x (5 mamba2 + mamba2_attn) + 3 tail."""
from repro_torch.config import ModelConfig, SsmConfig
from repro_torch.configs.common import SCALE_WASI, SMOKE_WASI, patterned_groups


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-7b", family="lm",
        n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32, d_ff=14336,
        vocab_size=32000, head_dim=112, mlp_act="swiglu", norm="rmsnorm",
        groups=patterned_groups(("mamba2",) * 5 + ("mamba2_attn",), 13,
                                tail=("mamba2",) * 3),
        ssm=SsmConfig(d_state=64, expand=2, d_conv=4, head_dim=64, chunk=256),
        wasi=SCALE_WASI, dtype="bfloat16", remat="block",
        sub_quadratic=True,  # hybrid — long_500k runs
        has_decoder=True)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-smoke", family="lm",
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab_size=256, head_dim=16, mlp_act="swiglu", norm="rmsnorm",
        groups=patterned_groups(("mamba2", "mamba2", "mamba2_attn"), 1),
        ssm=SsmConfig(d_state=8, expand=2, d_conv=4, head_dim=16, chunk=8),
        wasi=SMOKE_WASI, dtype="float32", remat="none", sub_quadratic=True)
