"""The port's factored linear against the reference's.

On the CPU ``repro_torch.kernels.ops.lowrank_matmul`` takes its plain
version (``ref.lowrank_matmul_ref``); it is held against the reference's
oracle ``repro.kernels.ref.lowrank_matmul_ref`` and against the Pallas
kernel itself in interpret mode (``repro.kernels.ops.lowrank_matmul_fused``).
The CUDA kernel is held against the plain version on the card in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro_torch.kernels import lowrank as tlowrank
from repro_torch.kernels import ops as tops

EPS32 = float(np.finfo(np.float32).eps)

# (lead dims, I, K, O): ragged M/I/K/O, leading dims, and the four site
# shapes of qwen2-0.5b's plan (attn/wq|wo, attn/wk|wv, mlp/gate|up,
# mlp/down) at small M
SHAPES = [((4, 32), 96, 24, 48), ((3, 17), 70, 5, 33), ((1, 257), 130, 100, 7),
          ((5, 1), 9, 3, 513), ((2, 3, 7), 64, 16, 40),
          ((4,), 896, 256, 896), ((4,), 896, 128, 128),
          ((4,), 896, 256, 4864), ((4,), 4864, 256, 896)]


def _inputs(lead, i, k, o, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(lead + (i,)).astype(np.float32)
    r = (rng.standard_normal((k, i)) * i ** -0.5).astype(np.float32)
    l_ = (rng.standard_normal((o, k)) * k ** -0.5).astype(np.float32)
    return x, r, l_


def _f32_tol(i, k, scale):
    # f32 sums of I then K terms taken in different orders: the textbook
    # bound n * eps * sum|terms|, with |y| as the scale of the terms
    return 2 * (i + k) * EPS32 * max(scale, 1.0)


@pytest.mark.parametrize("lead,i,k,o", SHAPES)
def test_plain_version_matches_reference_oracle_f32(lead, i, k, o):
    x, r, l_ = _inputs(lead, i, k, o)
    got = tops.lowrank_matmul(torch.from_numpy(x), torch.from_numpy(r),
                              torch.from_numpy(l_)).numpy()
    want = np.asarray(rref.lowrank_matmul_ref(
        jnp.asarray(x.reshape(-1, i)), jnp.asarray(r),
        jnp.asarray(l_))).reshape(lead + (o,))
    assert got.shape == want.shape
    tol = _f32_tol(i, k, np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


@pytest.mark.parametrize("lead,i,k,o", SHAPES)
def test_plain_version_matches_reference_oracle_bf16(lead, i, k, o):
    """bf16 in, bf16 out, h kept in f32 on both sides: the two results are
    f32 values a few ulps apart rounded to bf16, so they differ by at most
    one bf16 ulp (up to 2^-7 relative, at the bottom of a binade)."""
    x, r, l_ = _inputs(lead, i, k, o, seed=1)
    xt, rt, lt = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, r, l_))
    got = tops.lowrank_matmul(xt, rt, lt)
    assert got.dtype == torch.bfloat16
    want = rref.lowrank_matmul_ref(
        jnp.asarray(x.reshape(-1, i), jnp.bfloat16),
        jnp.asarray(r, jnp.bfloat16), jnp.asarray(l_, jnp.bfloat16))
    assert want.dtype == jnp.bfloat16
    got = got.float().numpy().reshape(-1, o)
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=2.0 ** -7,
                               atol=_f32_tol(i, k, np.abs(want).max()))


@pytest.mark.parametrize("lead,i,k,o", SHAPES)
def test_plain_version_matches_pallas_kernel_interpret(lead, i, k, o):
    x, r, l_ = _inputs(lead, i, k, o, seed=2)
    got = tops.lowrank_matmul(torch.from_numpy(x), torch.from_numpy(r),
                              torch.from_numpy(l_)).numpy()
    want = np.asarray(rops.lowrank_matmul_fused(
        jnp.asarray(x), jnp.asarray(r), jnp.asarray(l_)))
    tol = _f32_tol(i, k, np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def test_cpu_path_never_counts_a_launch():
    tops.reset_launches()
    x, r, l_ = _inputs((8,), 32, 8, 16)
    tops.lowrank_matmul(torch.from_numpy(x), torch.from_numpy(r),
                        torch.from_numpy(l_))
    assert tops.LAUNCHES == {"lowrank_fwd": 0, "lowrank_q8": 0,
                            "matmul_tiled": 0, "flash_attention": 0,
                            "ssd_scan": 0}


def test_kernel_wrapper_refuses_cpu_tensors():
    x, r, l_ = (torch.from_numpy(a) for a in _inputs((8,), 32, 8, 16))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        tlowrank.lowrank_fused(x, r, l_)
    assert tops.LAUNCHES["lowrank_fwd"] == 0


@pytest.mark.parametrize("m,k,o", [(4, 256, 4864), (4, 256, 896),
                                   (4, 128, 128), (1024, 256, 4864),
                                   (37, 5, 19), (1, 1, 1), (300, 1000, 70)])
def test_launch_config_covers_the_output(m, k, o):
    cfg = tlowrank.launch_config(m, k, o)
    assert cfg.bm in (16, 64)
    assert cfg.ks % 8 == 0 and tlowrank.CLUSTER * cfg.ks >= k
    assert tlowrank.CLUSTER * cfg.groups * cfg.oc >= o
    assert tlowrank.CLUSTER * cfg.groups * (cfg.oc - 1) < o
    assert cfg.smem <= tlowrank.SMEM_LIMIT
    assert cfg.smem == tlowrank.smem_bytes(cfg.bm, cfg.ks)


def test_launch_config_refuses_a_rank_that_cannot_stay_on_chip():
    with pytest.raises(ValueError, match="shared memory"):
        tlowrank.launch_config(4, 8192, 64)
