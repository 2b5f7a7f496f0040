"""falcon-mamba-7b [ssm] 64L d_model=4096 (attn-free) vocab=65024
ssm_state=16 — mamba1 arch [arXiv:2410.05355; unverified].

Attention-free: WASI still applies to its four Mamba-1 projections
(``ssm/in_proj``, ``ssm/x_proj``, ``ssm/dt_proj``, ``ssm/out_proj``)."""
from repro_torch.config import ModelConfig, SsmConfig
from repro_torch.configs.common import SCALE_WASI, SMOKE_WASI, uniform_groups


def config() -> ModelConfig:
    return ModelConfig(
        name="falcon-mamba-7b", family="lm",
        n_layers=64, d_model=4096, n_heads=1, n_kv_heads=1, d_ff=0,
        vocab_size=65024, head_dim=64, norm="rmsnorm",
        groups=uniform_groups("mamba1", 64),
        ssm=SsmConfig(d_state=16, expand=2, d_conv=4, dt_rank=256),
        wasi=SCALE_WASI, dtype="bfloat16", remat="block",
        sub_quadratic=True, has_decoder=True)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="falcon-mamba-smoke", family="lm",
        n_layers=2, d_model=64, n_heads=1, n_kv_heads=1, d_ff=0,
        vocab_size=256, head_dim=16, norm="rmsnorm",
        groups=uniform_groups("mamba1", 2),
        ssm=SsmConfig(d_state=8, expand=2, d_conv=4, dt_rank=8),
        wasi=SMOKE_WASI, dtype="float32", remat="none", sub_quadratic=True)
