"""vit-base: the paper's primary experimental model (ViT-B/16). 12L
d_model=768 12H d_ff=3072, 196 patches + cls, ImageNet-1K pretrain."""
from repro_torch.config import AsiConfig, ModelConfig, WasiConfig
from repro_torch.configs.common import SMOKE_WASI, uniform_groups

# Paper-faithful setting: eps-controlled ranks, project update mode, MLP
# scope for the main experiments (Fig. 5); scope="all" for Tab. 1.
PAPER_WASI = WasiConfig(
    method="wasi", scope="mlp", epsilon=0.8, rank_frac=0.33, rank_align=1,
    min_rank=4, update_mode="project",
    asi=AsiConfig(batch_frac=0.25, token_frac=0.25, feature_frac=0.25,
                  align=1, skip_batch=False))


def config() -> ModelConfig:
    return ModelConfig(
        name="vit-base", family="vit",
        n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, d_ff=3072,
        vocab_size=0, head_dim=64, mlp_act="gelu", norm="layernorm",
        rope_theta=0.0, groups=uniform_groups("dense", 12),
        wasi=PAPER_WASI, dtype="float32", remat="none",
        sub_quadratic=False, has_decoder=False)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="vit-smoke", family="vit",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab_size=0, head_dim=16, mlp_act="gelu", norm="layernorm",
        rope_theta=0.0, groups=uniform_groups("dense", 2),
        wasi=SMOKE_WASI, dtype="float32", remat="none", has_decoder=False)
