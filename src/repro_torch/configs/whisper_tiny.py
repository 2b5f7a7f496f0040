"""whisper-tiny [audio] 4L d_model=384 6H (kv=6) d_ff=1536 vocab=51865 —
enc-dec, conv frontend stub [arXiv:2212.04356; unverified].

Frontend is a STUB: the encoder takes precomputed frame embeddings
(B, 1500, 384). Sinusoidal positions (rope_theta=0)."""
from repro_torch.config import ModelConfig
from repro_torch.configs.common import SCALE_WASI, SMOKE_WASI


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-tiny", family="encdec",
        n_layers=4, n_enc_layers=4, enc_seq=1500,
        d_model=384, n_heads=6, n_kv_heads=6, d_ff=1536,
        vocab_size=51865, head_dim=64, mlp_act="gelu", norm="layernorm",
        rope_theta=0.0,
        groups=(),  # encdec has its own enc/dec stacks
        wasi=SCALE_WASI, dtype="bfloat16", remat="block",
        sub_quadratic=False,  # full self+cross attention -> skip long_500k
        has_decoder=True)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-smoke", family="encdec",
        n_layers=2, n_enc_layers=2, enc_seq=16,
        d_model=32, n_heads=2, n_kv_heads=2, d_ff=64,
        vocab_size=128, head_dim=16, mlp_act="gelu", norm="layernorm",
        rope_theta=0.0, groups=(),
        wasi=SMOKE_WASI, dtype="float32", remat="none")
