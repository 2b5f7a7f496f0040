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


# ---------------------------------------------------------------------------
# the route rule of the serving forward (forward_route) and its plans
# ---------------------------------------------------------------------------

BF = torch.bfloat16
D = tlowrank.DECODE_MAX_M
# (I, K, O) of every serving site: qwen2-0.5b's and zamba2-7b's
SITE_WIDTHS = [(896, 256, 896), (896, 128, 128), (896, 256, 4864),
               (4864, 256, 896), (3584, 896, 14336), (3584, 128, 240),
               (7168, 896, 3584), (3584, 896, 3584), (14336, 896, 3584)]


def _aligned():
    return (torch.zeros(8, 896, dtype=BF),)


@pytest.mark.parametrize("m", [1, 4, D])
@pytest.mark.parametrize("dtype", [BF, torch.float32])
def test_forward_route_takes_decode_up_to_the_threshold(m, dtype):
    for i, k, o in SITE_WIDTHS:
        assert tlowrank.forward_route(m, i, k, o, dtype, _aligned()) == \
            "decode"


@pytest.mark.parametrize("m", [D + 1, 37, 256, 1024])
def test_forward_route_takes_the_tensor_cores_above_the_threshold(m):
    for i, k, o in SITE_WIDTHS:
        assert tlowrank.forward_route(m, i, k, o, BF, _aligned()) == \
            "tensor_core"


def test_zamba2_prefill_takes_the_tensor_core_route():
    """zamba2-7b's in_proj at a prefill bucket's 1,024 rows: no rank has to
    fit on chip there, so the 16-row tiles of the fused kernel are gone."""
    assert tlowrank.forward_route(1024, 3584, 896, 14336, BF,
                                  _aligned()) == "tensor_core"
    plan = tlowrank.sketch_plan(1024, 3584, 896, 14336)
    assert plan.h.tile == plan.y.tile == 128


# (M, K, O) -> the fused kernel's launch_config, as it stands
FUSED_CONFIGS = {(37, 5, 33): (64, 8, 5, 1, 76288),
                 (300, 5, 33): (64, 8, 5, 1, 76288),
                 (4, 5, 33): (16, 8, 5, 1, 25600),
                 (37, 256, 896): (64, 32, 16, 7, 86528),
                 (1024, 256, 4864): (64, 32, 203, 3, 86528),
                 (4, 100, 7): (16, 16, 1, 1, 26112)}


def test_f32_and_unaligned_bf16_keep_the_fused_kernel():
    """f32 above the threshold, bf16 widths that are not multiples of 8
    and misaligned bases at any M take lowrank_fwd.cu, through
    launch_config unchanged."""
    x = _aligned()
    for m in (D + 1, 37, 1024):
        assert tlowrank.forward_route(m, 896, 256, 896, torch.float32,
                                      x) == "fused"
    for m in (1, 4, 37, 300):
        for dtype in (BF, torch.float32):
            assert tlowrank.forward_route(m, 70, 5, 33, dtype, x) == "fused"
            assert tlowrank.forward_route(m, 96, 24, 44, dtype, x) == "fused"
    flat = torch.zeros(8 * 896 + 8, dtype=BF)
    shifted = flat[1:1 + 8 * 896].view(8, 896)
    for m in (4, 300):
        assert tlowrank.forward_route(m, 896, 256, 896, BF,
                                      (shifted,)) == "fused"
    for (m, k, o), want in FUSED_CONFIGS.items():
        assert tuple(tlowrank.launch_config(m, k, o)) == want


def test_decode_route_needs_its_staged_h_to_fit():
    """h (8 nt rows, three bf16 pieces) is staged in shared memory by the
    second launch: a rank whose pieces do not fit leaves the decode
    route."""
    assert tlowrank.decode_smem_bytes(1, 896) == 3 * 8 * (896 + 32) * 2
    assert tlowrank.decode_smem_bytes(2, 100) == 3 * 16 * (128 + 32) * 2
    assert tlowrank.forward_route(4, 896, 8192, 896, BF, _aligned()) == \
        "tensor_core"
    assert tlowrank.forward_route(4, 896, 8192, 896, torch.float32,
                                  _aligned()) == "fused"


@pytest.mark.parametrize("m", [1, 4, D])
@pytest.mark.parametrize("i,k,o", SITE_WIDTHS + [(72, 40, 56), (8, 8, 8)])
def test_decode_plan_covers_the_output_and_fills_the_card(m, i, k, o):
    """n8 tiles cover M; h's grid has >= SMS blocks or one row tile a
    block, a cluster of 1-8 along I only then, each warp keeping >= 2
    slices of 32; y's grid likewise along O."""
    plan = tlowrank.decode_plan(m, i, k, o)
    assert 8 * plan.nt >= m and plan.nt == tlowrank.n8_tiles(m)
    warps = tlowrank.DECODE_WARPS
    for wk, rows in ((plan.wk_h, k), (plan.wk_y, o)):
        assert wk in (1, 2, 4, 8)
        blocks = -(-(-(-rows // 16)) // (warps // wk))
        assert blocks >= tlowrank.SMS or wk == warps
        if wk > 1:     # one warp fewer along the reduction would not fill
            assert -(-(-(-rows // 16)) // (warps // (wk // 2))) < \
                tlowrank.SMS
    assert 1 <= plan.cluster <= tlowrank.DECODE_MAX_CLUSTER
    if plan.cluster > 1:
        blocks = -(-(-(-k // 16)) // (warps // plan.wk_h))
        assert blocks * (plan.cluster - 1) < tlowrank.SMS
        slices = -(-i // tlowrank.DECODE_SLICE)
        assert slices // (plan.cluster * plan.wk_h) >= 2


def test_forward_wrapper_raises_on_cpu_tensors_before_any_build(monkeypatch):
    """Whatever the route of the shape, a CPU tensor raises in the
    wrapper's checks: no library is built or loaded, nothing counts."""
    from repro_torch.kernels import _build

    def no_build(source):
        raise AssertionError(f"built {source}")

    monkeypatch.setattr(_build, "library", no_build)
    before = dict(tops.LAUNCHES)
    for m, (i, k, o), dtype in ((4, (896, 256, 896), BF),
                                (4, (896, 256, 896), torch.float32),
                                (300, (896, 256, 896), BF),
                                (37, (70, 5, 33), BF)):
        x, r, l_ = (torch.from_numpy(a).to(dtype)
                    for a in _inputs((m,), i, k, o))
        with pytest.raises(ValueError, match="CUDA tensors only"):
            tlowrank.lowrank_fused(x, r, l_)
    assert tops.LAUNCHES == before
