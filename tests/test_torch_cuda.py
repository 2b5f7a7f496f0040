"""The CUDA kernel against its plain version, on the card.

Every test here needs a CUDA device and skips without one. This file
imports neither JAX nor the JAX package, so it also runs on a machine
that has only the port's stack:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import lowrank, ops, ref

EPS32 = float(np.finfo(np.float32).eps)

# (lead dims, I, K, O): ragged M/I/K/O, leading dims, odd I (unaligned
# bf16 pairs), and the four site shapes of qwen2-0.5b at decode and
# prefill row counts
SHAPES = [((4, 32), 96, 24, 48), ((3, 17), 70, 5, 33), ((1, 257), 130, 100, 7),
          ((5, 1), 9, 3, 513), ((2, 3, 7), 64, 16, 40), ((6,), 37, 300, 19),
          ((4,), 896, 256, 896), ((4,), 896, 128, 128),
          ((4,), 896, 256, 4864), ((4,), 4864, 256, 896),
          ((300,), 896, 256, 4864), ((97,), 4864, 256, 896)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode "
                    "(run on the card, see README 'PyTorch/CUDA port')")
    return torch.device("cuda")


def _inputs(lead, i, k, o, device, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(*lead, i, generator=g)
    r = torch.randn(k, i, generator=g) * i ** -0.5
    l_ = torch.randn(o, k, generator=g) * k ** -0.5
    return tuple(t.to(device, dtype) for t in (x, r, l_))


@pytest.mark.cuda
@pytest.mark.parametrize("lead,i,k,o", SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_version(cuda, lead, i, k, o, dtype):
    """Tolerance: f32 sums of I then K terms in another order, bounded by
    2 (I + K) eps |y|; bf16 adds one rounding of the output (up to 2^-7
    relative)."""
    x, r, l_ = _inputs(lead, i, k, o, cuda, dtype)
    before = ops.LAUNCHES["lowrank_fwd"]
    got = ops.lowrank_matmul(x, r, l_)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["lowrank_fwd"] == before + 1
    assert got.shape == (*lead, o) and got.dtype == dtype
    want = ref.lowrank_matmul_ref(x, r, l_)
    scale = want.float().abs().max().item()
    tol = 2 * (i + k) * EPS32 * max(scale, 1.0)
    if dtype == torch.bfloat16:
        tol += 2.0 ** -7 * scale
    assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.cuda
def test_kernel_is_deterministic(cuda):
    x, r, l_ = _inputs((256,), 896, 256, 4864, cuda, torch.bfloat16)
    a = ops.lowrank_matmul(x, r, l_)
    b = ops.lowrank_matmul(x, r, l_)
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    x, r, l_ = _inputs((8,), 32, 8, 16, cuda, torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        lowrank.lowrank_fused(x.T.contiguous().T, r, l_)
    with pytest.raises(ValueError, match="dtypes differ"):
        lowrank.lowrank_fused(x, r.to(torch.bfloat16), l_)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        lowrank.lowrank_fused(x, r.cpu(), l_)
    with pytest.raises(ValueError, match="not supported"):
        lowrank.lowrank_fused(*(t.half() for t in (x, r, l_)))
    with pytest.raises(ValueError, match="do not chain"):
        lowrank.lowrank_fused(x, r[:, :16].contiguous(), l_)


@pytest.mark.cuda
@pytest.mark.parametrize("bm", [16, 64])
@pytest.mark.parametrize("ks", [8, 16, 32, 40, 128])
def test_smem_formula_matches_the_source(cuda, bm, ks):
    """The wrapper checks the per-CTA shared memory against the card's
    limit with its own copy of the source's formula; the two agree."""
    lib = lowrank._lib()
    assert lib.lowrank_fwd_smem_bytes(bm, ks) == lowrank.smem_bytes(bm, ks)


# ---------------------------------------------------------------------------
# The training kernels: sketch forward, backward, Gram, CholeskyQR
# ---------------------------------------------------------------------------

from repro_torch.core.orthogonal import (  # noqa: E402
    cholesky_qr_mix_ref,
    orthonormality_error,
)
from repro_torch.kernels import gram as kgram  # noqa: E402
from repro_torch.kernels import qr as kqr  # noqa: E402

# (M, I, K, O): ragged, and the four training sites of qwen2-0.5b at a
# ragged row count
BWD_SHAPES = [(64, 96, 24, 48), (37, 70, 5, 33), (257, 130, 100, 7),
              (1000, 896, 256, 896), (1000, 896, 128, 128),
              (1000, 896, 256, 4864), (1000, 4864, 256, 896)]


def _bwd_inputs(m, i, k, o, device, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(m, i, generator=g)
    r = torch.randn(k, i, generator=g) * i ** -0.5
    l_ = torch.randn(o, k, generator=g) * k ** -0.5
    dy = torch.randn(m, o, generator=g)
    x, r, l_, dy = (t.to(device, dtype) for t in (x, r, l_, dy))
    h = x.float() @ r.float().T
    return dy, x, h, l_, r


def _tol(want, n, dtype=torch.float32):
    """f32 sums of n terms in another order: n eps |result scale|; a bf16
    output adds one rounding (2^-7 relative)."""
    scale = want.float().abs().max().item()
    tol = 2 * n * EPS32 * max(scale, 1.0)
    if dtype == torch.bfloat16:
        tol += 2.0 ** -7 * scale
    return tol


def _close(got, want, n, dtype=torch.float32):
    tol = _tol(want, n, dtype)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol, (err, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("m,i,k,o", BWD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sketch_kernel_matches_plain_version(cuda, m, i, k, o, dtype):
    _, x, _, l_, r = _bwd_inputs(m, i, k, o, cuda, dtype)
    before = dict(ops.launch_counts())
    y, h = lowrank.lowrank_fused(x, r, l_, save_sketch=True)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert after["lowrank_fwd_sketch"] == before["lowrank_fwd_sketch"] + 1
    assert after["lowrank_fwd"] == before["lowrank_fwd"]
    assert h.dtype == torch.float32 and h.shape == (m, k)
    want_y, want_h = ref.lowrank_sketch_ref(x, r, l_)
    _close(h, want_h, i)
    _close(y, want_y, i + k, dtype)
    y1 = lowrank.lowrank_fused(x, r, l_)
    if dtype == torch.float32:
        # one kernel computes both: the sketch store changes nothing of y
        assert torch.equal(y, y1)
    else:
        # bf16: #2 takes the tensor-core route (y over bf16 pieces of h)
        # where it admits the shape, #1 never does; each is held to the
        # plain version, so to each other at the sum of the two tolerances
        err = (y.float() - y1.float()).abs().max().item()
        assert err <= 2 * _tol(want_y, i + k, dtype), err


@pytest.mark.cuda
@pytest.mark.parametrize("m,i,k,o", BWD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_kernel_matches_plain_version(cuda, m, i, k, o, dtype):
    """dx sums O then K terms, dL M terms, dR O then M terms."""
    dy, x, h, l_, r = _bwd_inputs(m, i, k, o, cuda, dtype)
    before = ops.launch_counts()["lowrank_bwd"]
    dx, dl, dr = lowrank.lowrank_bwd(dy, x, h, l_, r)
    torch.cuda.synchronize()
    assert ops.launch_counts()["lowrank_bwd"] == before + 1
    assert dx.dtype == dtype and dl.dtype == dr.dtype == torch.float32
    want = ref.lowrank_bwd_ref(dy, x, h, l_, r)
    _close(dx, want[0], o + k, dtype)
    _close(dl, want[1], m)
    _close(dr, want[2], o + m)
    again = lowrank.lowrank_bwd(dy, x, h, l_, r)
    assert all(torch.equal(a, b) for a, b in zip((dx, dl, dr), again))


# (M, I, K, O): the four training sites at one row and at the training
# path's 2048 rows
TC_SHAPES = [(m, i, k, o) for m in (1, 2048)
             for i, k, o in ((896, 256, 896), (896, 128, 128),
                             (896, 256, 4864), (4864, 256, 896))]


@pytest.mark.cuda
@pytest.mark.parametrize("m,i,k,o", BWD_SHAPES + TC_SHAPES)
def test_bf16_kernels_route_match_and_repeat(cuda, m, i, k, o):
    """bf16 #2 and #3: widths that are multiples of 8 take the tensor-core
    route (bf16 pieces of h and dh), the others the f32 FMA kernels; either
    way each output is held to the plain version, two calls give the same
    bits, and each wrapper call counts one launch."""
    dy, x, h, l_, r = _bwd_inputs(m, i, k, o, cuda, torch.bfloat16)
    tc = all(w % 8 == 0 for w in (i, k, o))
    assert lowrank.tensor_core_route(torch.bfloat16, (i, k, o),
                                     (dy, x, h, l_, r)) == tc
    before = dict(ops.launch_counts())
    fwd = [lowrank.lowrank_fused(x, r, l_, save_sketch=True)
           for _ in range(2)]
    bwd = [lowrank.lowrank_bwd(dy, x, h, l_, r) for _ in range(2)]
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert after["lowrank_fwd_sketch"] == before["lowrank_fwd_sketch"] + 2
    assert after["lowrank_bwd"] == before["lowrank_bwd"] + 2
    assert after["lowrank_fwd"] == before["lowrank_fwd"]
    assert all(torch.equal(a, b) for a, b in zip(*fwd))
    assert all(torch.equal(a, b) for a, b in zip(*bwd))
    want_y, want_h = ref.lowrank_sketch_ref(x, r, l_)
    _close(fwd[0][1], want_h, i)
    _close(fwd[0][0], want_y, i + k, torch.bfloat16)
    want = ref.lowrank_bwd_ref(dy, x, h, l_, r)
    _close(bwd[0][0], want[0], o + k, torch.bfloat16)
    _close(bwd[0][1], want[1], m)
    _close(bwd[0][2], want[2], o + m)


@pytest.mark.cuda
def test_bf16_kernels_take_misaligned_views_to_the_fma_kernels(cuda):
    """A bf16 operand whose base is not 16-byte aligned goes to the f32
    FMA kernels by the route rule, and the result is still right."""
    m, i, k, o = 64, 896, 256, 896
    dy, x, h, l_, r = _bwd_inputs(m, i, k, o, cuda, torch.bfloat16)
    flat = torch.empty(m * i + 1, dtype=torch.bfloat16, device=cuda)
    xs = flat[1:].view(m, i)
    xs.copy_(x)
    assert not lowrank.tensor_core_route(torch.bfloat16, (i, k, o), (xs,))
    y, hh = lowrank.lowrank_fused(xs, r, l_, save_sketch=True)
    dx, dl, dr = lowrank.lowrank_bwd(dy, xs, h, l_, r)
    torch.cuda.synchronize()
    want_y, want_h = ref.lowrank_sketch_ref(x, r, l_)
    _close(hh, want_h, i)
    _close(y, want_y, i + k, torch.bfloat16)
    want = ref.lowrank_bwd_ref(dy, x, h, l_, r)
    _close(dx, want[0], o + k, torch.bfloat16)
    _close(dl, want[1], m)
    _close(dr, want[2], o + m)


GRAM_SHAPES = [(1, 2048, 256), (3, 100, 40), (24, 4864, 256),
               (24, 896, 128), (2, 37, 5)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,m,k", GRAM_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gram_kernel_matches_plain_version(cuda, b, m, k, dtype):
    y = torch.randn(b, m, k, generator=torch.Generator().manual_seed(3))
    y = y.to(cuda, dtype)
    if b == 1:
        y = y[0]
    print(f"gram ({b}, {m}, {k}) {dtype}: route "
          f"{kgram.gram_route(dtype, k, (y,))}")
    before = ops.launch_counts()["gram"]
    g = ops.gram(y)
    torch.cuda.synchronize()
    assert ops.launch_counts()["gram"] == before + 1
    _close(g, ref.gram_ref(y), m)
    assert torch.equal(g, g.mT)          # exactly symmetric


@pytest.mark.cuda
def test_gram_shapes_cover_both_routes(cuda):
    """GRAM_SHAPES in both dtypes reach both routes of ``gram_route``:
    the tensor cores (bf16, K a multiple of 8) and the f32 FMAs."""
    routes = {}
    for b, m, k in GRAM_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            y = torch.zeros(b, m, k, device=cuda, dtype=dtype)
            routes[(b, m, k, str(dtype))] = kgram.gram_route(dtype, k, (y,))
    print(routes)
    assert set(routes.values()) == {"tensor_core", "fma"}
    assert routes[(2, 37, 5, "torch.bfloat16")] == "fma"
    assert routes[(24, 4864, 256, "torch.bfloat16")] == "tensor_core"


# the four stacked sites of a qwen2-0.5b refresh (repeat, O, K)
GRAM_STACKS = [(24, 896, 256), (24, 128, 128), (24, 4864, 256),
               (24, 896, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,m,k", GRAM_STACKS)
def test_gram_main_path_stacks_repeat_and_are_symmetric(cuda, b, m, k):
    """At the refresh's stacks (bf16: the tensor-core route's upper-triangle
    tiles): two calls give the same bits, G is exactly symmetric, and it
    is held to the plain version as ``test_gram_kernel_matches_plain_
    version`` holds it."""
    y = torch.randn(b, m, k, generator=torch.Generator().manual_seed(m))
    y = y.to(cuda, torch.bfloat16)
    assert kgram.gram_route(torch.bfloat16, k, (y,)) == "tensor_core"
    g, again = ops.gram(y), ops.gram(y)
    torch.cuda.synchronize()
    assert torch.equal(g, again)
    assert torch.equal(g, g.mT)
    _close(g, ref.gram_ref(y), m)


@pytest.mark.cuda
@pytest.mark.parametrize("b,m,k,plan", [
    (2, 700, 136, (64, 2)), (1, 2048, 256, (64, 8)), (3, 100, 40, (64, 1)),
    (2, 896, 256, (64, 3))])
def test_gram_tensor_core_plans(cuda, b, m, k, plan):
    """The tensor-core route unsplit and split (``gram_plan``'s choice at
    these stacks): G held to the plain version, exactly symmetric (a
    ragged K of 136 and 40 leaves partial tiles on the diagonal)."""
    assert tuple(kgram.gram_plan(b, m, k)) == plan
    y = torch.randn(b, m, k, generator=torch.Generator().manual_seed(k))
    y = y.to(cuda, torch.bfloat16)
    g = kgram.gram(y)
    torch.cuda.synchronize()
    assert torch.equal(g, g.mT)
    _close(g, ref.gram_ref(y), m)


@pytest.mark.cuda
@pytest.mark.parametrize("b,m,k", GRAM_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_choleskyqr_kernel_matches_plain_version(cuda, b, m, k, dtype):
    """Well-conditioned Gaussian Y (M >= K). Q against the plain version
    within 1e-3 relative (f32; the Cholesky of a K x K Gram amplifies the
    Gram's rounding by its condition number, small here), bf16 Q within
    two bf16 ulps; mix within 1e-3 of its scale; Q^T Q = I within 1e-3
    (f32) or a bf16 rounding per entry summed over M (bf16)."""
    y = torch.randn(b, m, k, generator=torch.Generator().manual_seed(4))
    y = y.to(cuda, dtype)
    if b == 1:
        y = y[0]
    before = ops.launch_counts()
    q, mix = kqr.choleskyqr(y)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert after["choleskyqr"] == before["choleskyqr"] + 1
    assert after["gram"] == before["gram"] + 1
    assert q.dtype == dtype and mix.dtype == torch.float32
    want_q, want_mix = ref.choleskyqr_ref(y)
    qs = want_q.float().abs().max().item()
    tol_q = 1e-3 * qs if dtype == torch.float32 else 2 * 2.0 ** -7 * qs
    assert (q.float() - want_q.float()).abs().max().item() <= tol_q
    ms = want_mix.abs().max().item()
    assert (mix - want_mix).abs().max().item() <= 1e-3 * ms
    ortho = orthonormality_error(q).max().item()
    assert ortho <= (1e-3 if dtype == torch.float32 else 2.0 ** -7 * k)
    # the batched plain version the CPU path takes (with its NaN ladder)
    lq, lmix = cholesky_qr_mix_ref(y)
    assert (mix - lmix).abs().max().item() <= 1e-3 * ms


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_function_gradients_on_the_card(cuda, dtype):
    """Grads through ops.lowrank_matmul reach x, R and L, through the
    sketch and backward kernels, and agree with the CPU's plain wiring."""
    m, i, k, o = 300, 896, 256, 896
    _, x, _, l_, r = _bwd_inputs(m, i, k, o, "cpu", torch.float32, seed=5)
    dy = torch.randn(m, o, generator=torch.Generator().manual_seed(6))
    grads = {}
    for dev in ("cpu", cuda):
        ts = [t.detach().to(dev, dtype).requires_grad_(True)
              for t in (x, r, l_)]
        before = ops.launch_counts()
        y = ops.lowrank_matmul(*ts)
        y.backward(dy.to(dev, dtype))
        grads[str(dev)] = [t.grad.float().cpu() for t in ts]
        after = ops.launch_counts()
        if dev != "cpu":
            assert after["lowrank_fwd_sketch"] == before["lowrank_fwd_sketch"] + 1
            assert after["lowrank_bwd"] == before["lowrank_bwd"] + 1
            assert after["lowrank_fwd"] == before["lowrank_fwd"]
    for a, b, n in zip(grads[str(cuda)], grads["cpu"], (o + k, o + m, m)):
        _close(a, b, n, dtype)


@pytest.mark.cuda
def test_training_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    dy, x, h, l_, r = _bwd_inputs(16, 32, 8, 24, cuda, torch.float32)
    with pytest.raises(ValueError, match="float32"):
        lowrank.lowrank_bwd(dy, x, h.to(torch.bfloat16), l_, r)
    with pytest.raises(ValueError, match="do not chain"):
        lowrank.lowrank_bwd(dy, x, h, l_[:, :4].contiguous(), r)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        kgram.gram(x.cpu())
    with pytest.raises(ValueError, match="not supported"):
        kqr.choleskyqr(x.half())


def _spiked(m, k, seed):
    """Y = U diag(s) V^T with one singular value 1 and k - 1 of 1e-5: the
    first shifted Cholesky of its Gram fails (chip_smoke.py phase 6)."""
    rng = np.random.default_rng(seed)
    u = np.linalg.qr(rng.standard_normal((m, k)))[0]
    v = np.linalg.qr(rng.standard_normal((k, k)))[0]
    s = np.full(k, 1e-5)
    s[0] = 1.0
    return ((u * s) @ v.T).astype(np.float32)


@pytest.mark.cuda
def test_choleskyqr_kernel_takes_the_shift_ladder(cuda):
    """A stack of a well-conditioned and an ill-conditioned index: the
    kernel retries exactly where the plain ladder does (on the card and on
    the CPU), and agrees within 1e-3 of the scale of Q and mix."""
    y0 = torch.randn(896, 256, generator=torch.Generator().manual_seed(5))
    y_cpu = torch.stack([y0, torch.from_numpy(_spiked(896, 256, 13))])
    y = y_cpu.to(cuda)
    q, mix, retried = kqr.choleskyqr(y, with_retry=True)
    torch.cuda.synchronize()
    wq, wmix, wretried = ref.choleskyqr_ref(y, with_retry=True)
    _, cmix, cretried = cholesky_qr_mix_ref(y_cpu, with_retry=True)
    assert cretried.tolist() == [False, True]
    assert retried.tolist() == wretried.tolist() == cretried.tolist()
    for j in range(2):
        for a, b in ((q[j], wq[j]), (mix[j], wmix[j]),
                     (mix[j].cpu(), cmix[j])):
            scale = b.abs().max().item()
            assert (a - b).abs().max().item() <= 1e-3 * scale


# ---------------------------------------------------------------------------
# The int8 kernel (kernel #6)
# ---------------------------------------------------------------------------

from repro_torch.kernels import quant as kquant  # noqa: E402
from repro_torch.quant import quantize_tensor  # noqa: E402

# (lead, I, K, O): the reference test's ragged shapes (I = 33, 257: int8
# rows not 2-byte aligned; K = 5, 40), and the sites of qwen2-0.5b at
# decode and prefill row counts
Q8_SHAPES = [((4,), 16, 4, 24), ((7,), 33, 5, 17), ((130,), 257, 40, 129),
             ((2, 64), 128, 32, 128), ((4,), 896, 256, 896),
             ((4,), 896, 128, 128), ((4,), 896, 256, 4864),
             ((4,), 4864, 256, 896), ((1024,), 896, 256, 4864),
             ((37,), 4864, 256, 896)]


def _q8_inputs(lead, i, k, o, device, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(*lead, i, generator=g).to(device, dtype)
    rq, rs = quantize_tensor(torch.randn(k, i, generator=g))
    lq, ls = quantize_tensor(torch.randn(o, k, generator=g))
    return (x,) + tuple(t.to(device) for t in (rq, rs, lq, ls))


@pytest.mark.cuda
@pytest.mark.parametrize("lead,i,k,o", Q8_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_q8_kernel_matches_plain_version(cuda, lead, i, k, o, dtype):
    """As kernel #1: f32 sums of I then K terms in another order, 2 (I + K)
    eps |y|; bf16 adds one rounding of the output. Two runs give the same
    bits."""
    x, rq, rs, lq, ls = _q8_inputs(lead, i, k, o, cuda, dtype)
    before = ops.launch_counts()
    got = ops.lowrank_matmul_q8(x, rq, rs, lq, ls)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert after["lowrank_q8"] == before["lowrank_q8"] + 1
    assert after["lowrank_fwd"] == before["lowrank_fwd"]
    assert got.shape == (*lead, o) and got.dtype == dtype
    _close(got, ref.lowrank_q8_ref(x, rq, rs, lq, ls), i + k, dtype)
    assert torch.equal(got, ops.lowrank_matmul_q8(x, rq, rs, lq, ls))


@pytest.mark.cuda
def test_q8_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    x, rq, rs, lq, ls = _q8_inputs((8,), 32, 8, 16, cuda, torch.float32)
    with pytest.raises(ValueError, match="int8"):
        kquant.lowrank_q8(x, rq.float(), rs, lq, ls)
    with pytest.raises(ValueError, match="float32"):
        kquant.lowrank_q8(x, rq, rs.half(), lq, ls)
    with pytest.raises(ValueError, match="do not chain"):
        kquant.lowrank_q8(x, rq, rs, lq[:, :4].contiguous(), ls)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        kquant.lowrank_q8(x, rq.cpu(), rs, lq, ls)
    with pytest.raises(ValueError, match="not supported"):
        kquant.lowrank_q8(x.half(), rq, rs, lq, ls)


@pytest.mark.cuda
@pytest.mark.parametrize("bm", [16, 64])
@pytest.mark.parametrize("ks", [8, 32, 40])
def test_q8_smem_formula_matches_the_source(cuda, bm, ks):
    assert kquant._lib().lowrank_q8_smem_bytes(bm, ks) == \
        lowrank.smem_bytes(bm, ks)


# ---------------------------------------------------------------------------
# The tiled matmul (kernel #9) and the two-launch factored linear
# ---------------------------------------------------------------------------

from repro_torch.kernels import matmul_tiled as kmm  # noqa: E402

# (M, K, N): ragged edges on every dim, one row, strides that do and do
# not allow 16-byte loads (lda 257, 70; B rows of 300 or 1000), 128- and
# 64-wide tiles, and the products of the two-launch pair at qwen2-0.5b's
# sites
MM_SHAPES = [(33, 257, 129), (1, 5, 3), (130, 70, 7), (257, 16, 300),
             (70, 40, 1000), (1000, 896, 4864), (4, 4864, 256),
             (2048, 256, 896), (2048, 4864, 256)]


def _mm_tol(a, b, got_dtype):
    """Every product exact in f32 (bf16 x bf16 too), K of them summed in
    f32 in another order, tensor cores included: at most 2 K eps times the
    sum of |terms| of each output, bounded by (|A| |B|).max(). A bf16
    output is rounded on each side: two sums that straddle a rounding
    boundary land one bf16 ulp apart, up to 2^-7 of the value."""
    k = a.shape[1]
    absab = (a.float().abs() @ b.float().abs()).max().item()
    tol = 2 * k * EPS32 * max(absab, 1.0)
    if got_dtype == torch.bfloat16:
        want_scale = (a.float() @ b.float()).abs().max().item()
        tol += 2.0 ** -7 * want_scale
    return tol


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", MM_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b_layout", ["n_major", "k_major"])
def test_matmul_kernel_matches_plain_version(cuda, m, k, n, dtype, b_layout):
    g = torch.Generator().manual_seed(m + k + n)
    a = torch.randn(m, k, generator=g).to(cuda, dtype)
    if b_layout == "n_major":
        b = torch.randn(k, n, generator=g).to(cuda, dtype)
    else:   # a transposed view, as lowrank_matmul_unfused passes R.T
        b = torch.randn(n, k, generator=g).to(cuda, dtype).T
    before = ops.launch_counts()["matmul_tiled"]
    got = ops.matmul(a, b)
    torch.cuda.synchronize()
    assert ops.launch_counts()["matmul_tiled"] == before + 1
    assert got.shape == (m, n) and got.dtype == dtype
    want = ref.matmul_ref(a, b)
    assert (got.float() - want.float()).abs().max().item() <= \
        _mm_tol(a, b, dtype)
    assert torch.equal(got, ops.matmul(a, b))
    # the kernel's f32 output of bf16 operands: one f32 rounding only
    wide = kmm.matmul_tiled(a, b, torch.float32)
    assert wide.dtype == torch.float32
    assert (wide - ref.matmul_ref(a, b, torch.float32)).abs().max().item() \
        <= _mm_tol(a, b, torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [4, 1000])
@pytest.mark.parametrize("i,k,o", [(896, 256, 4864), (4864, 256, 896),
                                   (896, 128, 128)])
def test_unfused_pair_against_plain_and_fused(cuda, m, i, k, o):
    """Two launches, h written in x's dtype between them, held one product
    at a time: h (the first launch's bits: the kernel is deterministic)
    against the plain product, y against the plain product of that h and
    L^T, each within its product's bound. Against the fused kernel #1,
    which keeps h in f32: both outputs' bounds, plus h's bf16 rounding
    (at most 2^-8 |h|) and both first products' f32 sums (2 I eps
    (|x| |R^T|) each), carried through L."""
    x, r, l_ = _inputs((m,), i, k, o, cuda, torch.bfloat16)
    before = ops.launch_counts()["matmul_tiled"]
    got = ops.lowrank_matmul_unfused(x, r, l_)
    torch.cuda.synchronize()
    assert ops.launch_counts()["matmul_tiled"] == before + 2
    h = ops.matmul(x, r.T)
    assert h.dtype == torch.bfloat16
    assert (h.float() - ref.matmul_ref(x, r.T).float()).abs().max().item() \
        <= _mm_tol(x, r.T, torch.bfloat16)
    tol = _mm_tol(h, l_.T, torch.bfloat16)
    assert (got.float() - ref.matmul_ref(h, l_.T).float()).abs().max() \
        .item() <= tol
    fused = ops.lowrank_matmul(x, r, l_)
    hf = x.float() @ r.float().T
    dh = 2.0 ** -8 * hf.abs() \
        + 4 * i * EPS32 * (x.float().abs() @ r.float().abs().T)
    tol_f = 2 * tol + (dh @ l_.float().abs().T).max().item()
    assert (got.float() - fused.float()).abs().max().item() <= tol_f


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_matmul_kernel_on_unaligned_views(cuda, dtype):
    """Operands that start one element into their storage (no 16-byte
    loads) and a B whose strides are both above 1 (read element by
    element): the same results as the plain version."""
    g = torch.Generator().manual_seed(9)
    big = torch.randn(96, 201, generator=g).to(cuda, dtype)
    a = big[:, 1:]                        # (96, 200), offset 1, lda 201
    bbig = torch.randn(2, 200, 65, generator=g).to(cuda, dtype)
    for b in (bbig[0, :, 1:],             # row-major, offset 1
              bbig[:, :, :3].permute(1, 0, 2).reshape(200, 6),  # a copy
              bbig.transpose(0, 1)[:, 0, :64]):   # strides (65, 1) view
        got = ops.matmul(a, b)
        torch.cuda.synchronize()
        want = ref.matmul_ref(a, b)
        assert (got.float() - want.float()).abs().max().item() <= \
            _mm_tol(a, b, dtype)
    b = torch.randn(64, 200 * 3, generator=g).to(cuda, dtype)[:, ::3].T
    assert b.stride() == (3, 600)         # neither stride is 1
    got = ops.matmul(a, b)
    assert (got.float() - ref.matmul_ref(a, b).float()).abs().max().item() \
        <= _mm_tol(a, b, dtype)


@pytest.mark.cuda
def test_matmul_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    a = torch.randn(8, 16, device=cuda)
    b = torch.randn(16, 4, device=cuda)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        kmm.matmul_tiled(a, b.cpu())
    with pytest.raises(ValueError, match="one dtype"):
        kmm.matmul_tiled(a, b.bfloat16())
    with pytest.raises(ValueError, match="not supported"):
        kmm.matmul_tiled(a.half(), b.half())
    with pytest.raises(ValueError, match="do not chain"):
        kmm.matmul_tiled(a, b[:8])
    with pytest.raises(ValueError, match="unit stride"):
        kmm.matmul_tiled(torch.randn(16, 8, device=cuda).T, b)
    with pytest.raises(ValueError, match="2-D"):
        kmm.matmul_tiled(a[None], b)


# ---------------------------------------------------------------------------
# kernel #7: flash attention
# ---------------------------------------------------------------------------

import math  # noqa: E402

from repro_torch.kernels import flash_attention as kflash  # noqa: E402

# (B, Sq=Sk, H, KVH, dh, causal, window): the reference's sweep
# (tests/test_kernels.py::test_flash_attention_sweep: ragged 100, GQA,
# windows, dh 16-128), the path's shapes (ViT-B/16 at batch 4, qwen2's
# training rows), dh 8, 24 and 256 (the padded head dims), and a window
# without causal
FLASH_CASES = [(2, 128, 4, 2, 32, True, 0), (1, 256, 4, 4, 64, True, 64),
               (2, 100, 2, 1, 16, False, 0), (1, 384, 2, 2, 128, True, 128),
               (1, 64, 8, 2, 96, True, 0), (4, 197, 12, 12, 64, False, 0),
               (4, 512, 14, 2, 64, True, 0), (2, 70, 4, 2, 8, True, 0),
               (1, 130, 3, 1, 24, False, 0), (1, 80, 2, 2, 256, True, 0),
               (2, 150, 4, 2, 40, False, 33), (1, 256, 32, 32, 112, True, 0),
               # the dense decoder configs: tinyllama (GQA 32/4, dh 64),
               # stablelm (MHA, dh 80), granite (32/8, dh 128), internvl2
               # (48/8), gemma3 (8/4, dh 256, a window of 1,024 keys)
               (1, 512, 32, 4, 64, True, 0), (1, 300, 32, 32, 80, True, 0),
               (1, 256, 32, 8, 128, True, 0), (1, 200, 48, 8, 128, True, 0),
               (1, 1500, 8, 4, 256, True, 1024)]


def flash_tol(want: torch.Tensor, dtype) -> float:
    """f32: 2e-5 at unit-normal inputs, the online softmax's reassociation
    (expf and FMAs in another order). bf16: 2 ulps of the output's scale:
    the kernel rounds p to bf16 before p . v (as the TPU kernel does) and
    both sides round o to bf16."""
    if dtype == torch.float32:
        return 2e-5
    scale = want.float().abs().max().item()
    return 2 * 2.0 ** (math.floor(math.log2(scale)) - 7)


def _qkv(b, s, h, kvh, dh, device, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(b, s, n, dh, generator=g).to(device, dtype)
                 for n in (h, kvh, kvh))


def _nan_before(shape, dtype):
    """NaN where the next tensor of ``shape`` is allocated (free segments
    back to the driver, a NaN tensor of the size made and freed): an
    output a kernel leaves unwritten reads as NaN, not as an earlier
    call's values."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.full(shape, float("nan"), dtype=dtype, device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,kvh,dh,causal,window", FLASH_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain_version(cuda, b, s, h, kvh, dh, causal,
                                            window, dtype):
    q, k, v = _qkv(b, s, h, kvh, dh, cuda, dtype, seed=s + dh)
    before = ops.launch_counts()["flash_attention"]
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == before + 1
    assert got.shape == q.shape and got.dtype == dtype and got.is_contiguous()
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= flash_tol(want, dtype), err
    assert torch.equal(got, ops.flash_attention(q, k, v, causal=causal,
                                                window=window))
    # every plan instantiated at this dh, not only flash_plan's choice,
    # each on fresh inputs with its output's memory NaN first
    for i, plan in enumerate(kflash.plans(dh, dtype)):
        q, k, v = _qkv(b, s, h, kvh, dh, cuda, dtype, seed=s + dh + 1 + i)
        want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
        _nan_before(q.shape, dtype)
        o = kflash.flash_attention_cuda(q, k, v, causal=causal,
                                        window=window, plan=plan)
        err = (o.float() - want.float()).abs().max().item()
        assert err <= flash_tol(want, dtype), (plan, err)
        assert torch.equal(o, kflash.flash_attention_cuda(
            q, k, v, causal=causal, window=window, plan=plan))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_reads_strided_views(cuda, dtype):
    """q, k and v as views: heads sliced out of a wider tensor, a (B, H,
    S, dh) tensor permuted to (B, S, H, dh), and a storage offset of one
    element (no 16-byte loads): the same results as on contiguous
    copies."""
    for q, kk, vv in _strided_views(cuda, dtype, 3):
        got = ops.flash_attention(q, kk, vv, causal=True)
        want = ops.flash_attention(q.contiguous(), kk.contiguous(),
                                   vv.contiguous(), causal=True)
        ref_o = ref.flash_attention_ref(q, kk, vv, causal=True)
        assert (got.float() - want.float()).abs().max().item() <= \
            flash_tol(ref_o, dtype)
        assert (got.float() - ref_o.float()).abs().max().item() <= \
            flash_tol(ref_o, dtype)
    # every plan reads the views (the ring's plain loads where rows are
    # not 16-byte aligned), each on fresh inputs with its output's memory
    # NaN first
    for i, plan in enumerate(kflash.plans(32, dtype)):
        for q, kk, vv in _strided_views(cuda, dtype, 4 + i):
            ref_o = ref.flash_attention_ref(q, kk, vv, causal=True)
            _nan_before(q.shape, dtype)
            o = kflash.flash_attention_cuda(q, kk, vv, causal=True,
                                            plan=plan)
            assert (o.float() - ref_o.float()).abs().max().item() <= \
                flash_tol(ref_o, dtype), plan


def _strided_views(cuda, dtype, seed):
    """(q, k, v) as views: q, k and v sliced out of one wider tensor; q
    beside k permuted from (B, H, S, dh) and v at a storage offset of one
    element (no 16-byte loads)."""
    g = torch.Generator().manual_seed(seed)
    qkv = torch.randn(2, 90, 4 + 2 + 2, 32, generator=g).to(cuda, dtype)
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:]
    kt = torch.randn(2, 2, 90, 32, generator=g).to(cuda, dtype)
    off = torch.randn(2 * 90 * 2 * 32 + 1, generator=g).to(cuda, dtype)
    vo = off[1:].view(2, 90, 2, 32)
    return [(q, k, v), (q, kt.permute(0, 2, 1, 3), vo)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [16, 64, 112, 256])
def test_flash_smem_formula_matches_the_source(cuda, dh, dtype):
    lib = kflash._lib()
    code = 1 if dtype == torch.bfloat16 else 0
    for plan in kflash.plans(dh, dtype):
        assert lib.flash_attn_smem_bytes(plan.dp, code, plan.bq,
                                         plan.stages, plan.ks) == \
            kflash.flash_smem_bytes(plan.dp, dtype, plan.bq, plan.stages,
                                    plan.ks)


@pytest.mark.cuda
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0),
                                           (True, 48)])
def test_flash_gradient_matches_autograd_of_the_plain_version(cuda, causal,
                                                              window):
    """``_FlashAttention``: the kernel forward, the plain recomputed
    backward; dq, dk, dv against autograd through ``ref`` (f32, GQA):
    within 1e-5 of their scale (the same f32 math in another order)."""
    ts = [t.requires_grad_(True) for t in _qkv(2, 97, 6, 2, 32, cuda,
                                               torch.float32, seed=5)]
    before = ops.launch_counts()["flash_attention"]
    out = ops.flash_attention(*ts, causal=causal, window=window)
    dy = torch.randn_like(out)
    got = torch.autograd.grad(out, ts, dy)
    assert ops.launch_counts()["flash_attention"] == before + 1
    want_o = ref.flash_attention_ref(*ts, causal=causal, window=window)
    want = torch.autograd.grad(want_o, ts, dy)
    for a, w in zip(got, want):
        scale = w.abs().max().item()
        assert (a - w).abs().max().item() <= 1e-5 * scale


@pytest.mark.cuda
def test_flash_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    q, k, v = _qkv(1, 16, 4, 2, 32, cuda, torch.float32)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        kflash.flash_attention_cuda(q, k.cpu(), v)
    with pytest.raises(ValueError, match="one dtype"):
        kflash.flash_attention_cuda(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="multiple of 8"):
        kflash.flash_attention_cuda(q[..., :12], k[..., :12], v[..., :12])
    with pytest.raises(ValueError, match="multiple of"):
        kflash.flash_attention_cuda(q[:, :, :3], k, v)
    with pytest.raises(ValueError, match="unit stride"):
        kflash.flash_attention_cuda(q[..., ::2], k[..., :16], v[..., :16])
    with pytest.raises(ValueError, match="not supported"):
        kflash.flash_attention_cuda(q.half(), k.half(), v.half())


# ---------------------------------------------------------------------------
# kernel #8: the Mamba-2 SSD chunked scan
# ---------------------------------------------------------------------------

from repro_torch.kernels import ssd_scan as kssd  # noqa: E402

# (Bz, S, H, dh, N, chunk): the reference's sweep
# (tests/test_kernels.py::test_ssd_scan_kernel), ragged S (a short last
# chunk; one chunk of 37), zamba2's prefill bucket with its real widths
# (dh 64, N 64, Q 256; 16 of its 112 heads) and a 3-chunk prompt
SSD_CASES = [(2, 32, 4, 8, 4, 8), (1, 64, 2, 16, 8, 16),
             (1, 128, 8, 32, 16, 32), (2, 100, 3, 16, 8, 32),
             (1, 37, 2, 8, 4, 37), (2, 256, 16, 64, 64, 256),
             (1, 700, 4, 64, 64, 256)]


def ssd_tol(want: torch.Tensor) -> float:
    """1e-4 of the output's scale (at least 1e-4): f32 sums of up to
    Q + N terms and the prefix sum of dt A over the chunk in other
    orders. The plain f32 version sits within 8.1e-6 of the scale from a
    float64 evaluation at these shapes (CPU), so this is >10x either
    side's rounding."""
    return 1e-4 * max(1.0, want.abs().max().item())


def _ssd_inputs(bz, s, h, dh, n, device, seed=0, dtype=torch.float32,
                views=False):
    """u, dt, A, B, C drawn in f32; u, B and C then rounded to ``dtype``
    (the plain version reads the same values in f32). ``views``: B and C
    as row views of one (Bz, S, 2 N) tensor, as the Mamba-2 mixer hands
    them over."""
    g = torch.Generator().manual_seed(seed)
    u = torch.randn(bz, s, h, dh, generator=g)
    dt = torch.nn.functional.softplus(torch.randn(bz, s, h, generator=g))
    a = -torch.exp(torch.randn(h, generator=g))
    b = torch.randn(bz, s, n, generator=g)
    c = torch.randn(bz, s, n, generator=g)
    u, b, c = (t.to(dtype) for t in (u, b, c))
    if views:
        b, c = torch.split(torch.cat([b, c], -1).to(device), n, dim=-1)
    return tuple(t.to(device) for t in (u, dt, a, b, c))


def _ssd_routes(bz, s, h, dh, n):
    """(dtype, views, route) of every way the cases go in: f32 takes the
    FMA kernel; bf16 the tensor cores where dh and N are multiples of 16,
    contiguous or as row views alike."""
    tc = "tensor_core" if dh % 16 == 0 and n % 16 == 0 else "fma"
    return [(torch.float32, False, "fma"), (torch.float32, True, "fma"),
            (torch.bfloat16, False, tc), (torch.bfloat16, True, tc)]


@pytest.mark.cuda
@pytest.mark.parametrize("bz,s,h,dh,n,chunk", SSD_CASES)
def test_ssd_scan_kernel_matches_plain_version(cuda, bz, s, h, dh, n, chunk):
    """y (without D.u) and the final state against ``ref.ssd_scan_ref``,
    on every route: f32 and bf16 u, B and C, B and C contiguous or row
    views; two calls give the same bits; ``ops.ssd_scan`` launches the
    kernel once and adds D.u."""
    for dtype, views, route in _ssd_routes(bz, s, h, dh, n):
        args = _ssd_inputs(bz, s, h, dh, n, cuda, seed=s + dh, dtype=dtype,
                           views=views)
        assert kssd.ssd_route(args[0], args[3], args[4]) == route
        y, final = kssd.ssd_scan_cuda(*args, chunk)
        torch.cuda.synchronize()
        want_y, want_s = ref.ssd_scan_ref(*args, chunk)
        assert y.shape == want_y.shape and final.shape == want_s.shape
        assert y.dtype == final.dtype == torch.float32
        assert (y - want_y).abs().max().item() <= ssd_tol(want_y)
        assert (final - want_s).abs().max().item() <= ssd_tol(want_s)
        again = kssd.ssd_scan_cuda(*args, chunk)
        assert torch.equal(again[0], y) and torch.equal(again[1], final)
        d = torch.randn(h, device=cuda)
        before = ops.launch_counts()["ssd_scan"]
        y2, final2 = ops.ssd_scan(*args, d, chunk, return_final=True)
        assert ops.launch_counts()["ssd_scan"] == before + 1
        assert torch.equal(final2, final)
        assert torch.equal(y2, y + d[None, None, :, None] * args[0].float())


@pytest.mark.cuda
def test_ssd_scan_bf16_identity_steps_past_valid_length(cuda):
    """Bucketed prefill on the tensor-core route: dt = 0 past each row's
    valid length (identity steps) at zamba2's widths and chunk, over two
    chunks; y and the final state against the plain version."""
    u, dt, a, b, c = _ssd_inputs(3, 300, 4, 64, 64, cuda, seed=3,
                                 dtype=torch.bfloat16, views=True)
    live = (torch.arange(300, device=cuda)[None, :]
            < torch.tensor([300, 41, 257], device=cuda)[:, None])
    dt = torch.where(live[..., None], dt, 0.0)
    assert kssd.ssd_route(u, b, c) == "tensor_core"
    y, final = kssd.ssd_scan_cuda(u, dt, a, b, c, 256)
    want_y, want_s = ref.ssd_scan_ref(u, dt, a, b, c, 256)
    assert (y - want_y).abs().max().item() <= ssd_tol(want_y)
    assert (final - want_s).abs().max().item() <= ssd_tol(want_s)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 5, 64, 65, 300])
def test_ssd_scan_bf16_short_and_strided(cuda, s):
    """The tensor-core route at zamba2's widths and chunk (256) on
    sequences of one step, shorter than a tile, one tile, a tile and a
    step, and two chunks; u as a view of a wider tensor (its head stride
    72), B and C as row views. y and the final state against the plain
    version, two calls bit-equal."""
    u, dt, a, b, c = _ssd_inputs(2, s, 3, 64, 64, cuda, seed=s,
                                 dtype=torch.bfloat16, views=True)
    wide = torch.zeros(2, s, 3, 72, dtype=torch.bfloat16, device=cuda)
    wide[..., :64] = u
    u = wide[..., :64]
    assert kssd.ssd_route(u, b, c) == "tensor_core"
    y, final = kssd.ssd_scan_cuda(u, dt, a, b, c, 256)
    want_y, want_s = ref.ssd_scan_ref(u, dt, a, b, c, 256)
    assert (y - want_y).abs().max().item() <= ssd_tol(want_y)
    assert (final - want_s).abs().max().item() <= ssd_tol(want_s)
    again = kssd.ssd_scan_cuda(u, dt, a, b, c, 256)
    assert torch.equal(again[0], y) and torch.equal(again[1], final)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [256, 300, 700])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_gradients_on_the_card_match_the_cpu(cuda, s, dtype):
    """``ops.ssd_scan`` with grad on the card (``_SSDScan``: the kernel's
    forward, one launch; the plain chunked backward, none) at zamba2's
    head widths and chunk, one to three chunks, u, B and C in ``dtype``
    (B and C as row views): y and the final state's gradients (u, dt, A,
    B, C, D) against the CPU's plain autograd in f32 on the same values,
    within 8 eps sqrt(r) of each gradient's scale, r the terms an entry
    sums (``chip_smoke.ssd_grad_tol``'s count), plus 2^-8 for a gradient
    rounded to bf16; two runs bit-equal."""
    import math

    bz, h, dh, n, q = 2, 4, 64, 64, 256
    args = _ssd_inputs(bz, s, h, dh, n, cuda, seed=s, dtype=dtype,
                       views=True)
    g = torch.Generator().manual_seed(1)
    d = torch.randn(h, generator=g).to(cuda)
    wy = torch.randn(bz, s, h, dh, generator=g).to(cuda)
    wf = torch.randn(bz, h, dh, n, generator=g).to(cuda)
    leaves = [t.detach().requires_grad_() for t in (*args, d)]
    before = ops.launch_counts()["ssd_scan"]
    runs = []
    for _ in range(2):
        y, final = ops.ssd_scan(*leaves, q, return_final=True)
        runs.append(torch.autograd.grad((y * wy).sum() + (final * wf).sum(),
                                        leaves))
    torch.cuda.synchronize()
    assert ops.launch_counts()["ssd_scan"] == before + 2
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    cpu = [t.detach().float().cpu().requires_grad_() for t in leaves]
    py, pf = ref.ssd_scan_ref(*cpu[:5], q)
    want = torch.autograd.grad(
        ((py + cpu[5][None, None, :, None] * cpu[0]) * wy.cpu()).sum()
        + (pf * wf.cpu()).sum(), cpu)
    eps = torch.finfo(torch.float32).eps
    for name, got, w, t in zip("u dt A B C D".split(), runs[0], want,
                               leaves):
        assert got.dtype == t.dtype, name
        r = bz * s * min(q, s) * h * dh * n / got.numel()
        if name in ("dt", "A"):
            r *= min(q, s)
        tol = 8 * eps * math.sqrt(r) + (2.0 ** -8 if got.dtype
                                        == torch.bfloat16 else 0.0)
        scale = w.abs().max().item()
        assert (got.float().cpu() - w).abs().max().item() <= tol * scale, \
            name


@pytest.mark.cuda
def test_ssd_scan_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    u, dt, a, b, c = _ssd_inputs(1, 16, 2, 8, 4, cuda)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        kssd.ssd_scan_cuda(u, dt.cpu(), a, b, c, 8)
    with pytest.raises(ValueError, match="do not match"):
        kssd.ssd_scan_cuda(u, dt[:, :8], a, b, c, 8)
    wide = torch.zeros(1, 16, 2, 80, device=cuda)
    with pytest.raises(ValueError, match="must be in"):
        kssd.ssd_scan_cuda(wide, dt, a, b, c, 8)
    with pytest.raises(ValueError, match="shared memory"):
        kssd.ssd_scan_cuda(u, dt, a, b, c, 1 << 16)


@pytest.mark.cuda
def test_ssd_scan_smem_formula_matches_the_source(cuda):
    lib, tc = kssd._lib(), kssd._tc_lib()
    for q in (8, 37, 256, 1024):
        assert lib.ssd_scan_smem_bytes(q) == kssd.smem_bytes(q)
        for code, kernel in ((0, "chunk"), (2, "out")):
            assert tc.ssd_scan_tc_smem_bytes(code, q) == \
                kssd.tc_smem_bytes(kernel, q)
    assert tc.ssd_scan_tc_pieces() == kssd.PIECES


# ---------------------------------------------------------------------------
# the routes of kernel #1's serving forward and of kernel #9
# ---------------------------------------------------------------------------

BF, F32 = torch.bfloat16, torch.float32
D = lowrank.DECODE_MAX_M
# (M, I, K, O, dtype, route): the decode route at one row, at 4 (qwen2-0.5b
# and zamba2-7b sites, the cluster split of I at mlp/down and bcdt_proj)
# and at the threshold, in both dtypes; the tensor-core route just above
# the threshold, at a ragged M and at zamba2's in_proj prefill; the fused
# kernel for f32 above the threshold and for widths that are not
# multiples of 8 at any M
ROUTE_CASES = [(1, 896, 256, 896, BF, "decode"),
               (4, 896, 128, 128, BF, "decode"),
               (4, 4864, 256, 896, BF, "decode"),
               (D, 896, 256, 4864, BF, "decode"),
               (4, 3584, 896, 14336, BF, "decode"),
               (4, 3584, 128, 240, BF, "decode"),
               (D - 3, 72, 40, 56, BF, "decode"),
               (3, 96, 24, 48, F32, "decode"),
               (D, 4864, 256, 896, F32, "decode"),
               (D + 1, 896, 256, 896, BF, "tensor_core"),
               (37, 96, 24, 48, BF, "tensor_core"),
               (1024, 3584, 896, 14336, BF, "tensor_core"),
               (37, 896, 256, 896, F32, "fused"),
               (4, 70, 5, 33, BF, "fused"),
               (300, 70, 5, 33, BF, "fused")]


@pytest.mark.cuda
@pytest.mark.parametrize("m,i,k,o,dtype,route", ROUTE_CASES)
def test_forward_routes_match_plain_version_and_repeat(cuda, m, i, k, o,
                                                       dtype, route):
    """Each route of ``lowrank_fused`` (no sketch): the rule picks it,
    each call counts one launch of ``lowrank_fwd`` whatever the route
    launches, two calls give the same bits, and y is held to the plain
    version: f32 sums of I then K terms in another order, 2 (I + K) eps
    |y|, plus one bf16 rounding (the tensor-core route's two pieces of h
    add at most 2^-17 of each term, far inside that)."""
    x, r, l_ = _inputs((m,), i, k, o, cuda, dtype, seed=m + i + o)
    assert lowrank.forward_route(m, i, k, o, dtype, (x, r, l_)) == route
    before = dict(ops.launch_counts())
    got = [lowrank.lowrank_fused(x, r, l_) for _ in range(2)]
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert after["lowrank_fwd"] == before["lowrank_fwd"] + 2
    assert all(after[n] == before[n] for n in after if n != "lowrank_fwd")
    assert torch.equal(got[0], got[1])
    assert got[0].shape == (m, o) and got[0].dtype == dtype
    _close(got[0], ref.lowrank_matmul_ref(x, r, l_), i + k, dtype)


@pytest.mark.cuda
def test_forward_routes_refuse_cpu_tensors_before_any_build(cuda,
                                                            monkeypatch):
    """A CPU operand at any route's shape raises in the wrapper's checks,
    before a library is built or loaded, and counts nothing."""
    from repro_torch.kernels import _build

    def no_build(source):
        raise AssertionError(f"built {source}")

    monkeypatch.setattr(_build, "library", no_build)
    before = dict(ops.launch_counts())
    for m, i, k, o, dtype, _ in ROUTE_CASES:
        x, r, l_ = _inputs((m,), i, k, o, cuda, dtype)
        with pytest.raises(ValueError, match="CUDA tensors only"):
            lowrank.lowrank_fused(x, r.cpu(), l_)
    a = torch.randn(4, 896, device=cuda).bfloat16()
    with pytest.raises(ValueError, match="CUDA tensors only"):
        kmm.matmul_tiled(a, torch.randn(256, 896).bfloat16().T)
    assert ops.launch_counts() == before


# (M, K, N): the two products of the two-launch pair at decode rows
# (mlp/gate|up's first, mlp/down's first and second), a training row's
# pair, a ragged M with K and N multiples of 8, and one row
MM_TC_SHAPES = [(4, 896, 256), (4, 256, 4864), (4, 4864, 256),
                (2048, 896, 256), (2048, 256, 4864), (33, 264, 136),
                (1, 8, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", MM_TC_SHAPES)
@pytest.mark.parametrize("b_layout", ["n_major", "k_major"])
@pytest.mark.parametrize("out_dtype", [BF, F32])
def test_matmul_tensor_core_route_matches_plain_and_repeats(
        cuda, m, k, n, b_layout, out_dtype):
    """#9's tensor-core route: the rule picks it for bf16 operands in
    either B layout; one count per call; bit-equal repeats; held to the
    plain version at ``_mm_tol`` (every product exact, K f32 sums in
    another order, one rounding of a bf16 output)."""
    g = torch.Generator().manual_seed(m + k + n)
    a = torch.randn(m, k, generator=g).to(cuda, BF)
    b = (torch.randn(k, n, generator=g).to(cuda, BF) if b_layout == "n_major"
         else torch.randn(n, k, generator=g).to(cuda, BF).T)
    assert kmm.matmul_route(a, b) == "tensor_core"
    assert kmm.b_layout(b) == b_layout
    before = ops.launch_counts()["matmul_tiled"]
    got = [kmm.matmul_tiled(a, b, out_dtype) for _ in range(2)]
    torch.cuda.synchronize()
    assert ops.launch_counts()["matmul_tiled"] == before + 2
    assert torch.equal(got[0], got[1])
    assert got[0].dtype == out_dtype and got[0].shape == (m, n)
    want = ref.matmul_ref(a, b, out_dtype)
    assert (got[0].float() - want.float()).abs().max().item() <= \
        _mm_tol(a, b, out_dtype)


@pytest.mark.cuda
def test_matmul_route_keeps_f32_and_other_strides_on_the_tiled_kernel(cuda):
    """f32, a K that is not a multiple of 8 and a B whose strides the
    copies cannot read take the tiled kernel, still right."""
    g = torch.Generator().manual_seed(2)
    a = torch.randn(4, 896, generator=g).to(cuda)
    b = torch.randn(896, 256, generator=g).to(cuda)
    cases = [(a, b), (a[:, :893].bfloat16(), b[:893].bfloat16()),
             (a.bfloat16(), b.bfloat16()[:, ::2])]
    for aa, bb in cases:
        assert kmm.matmul_route(aa, bb) == "tiled"
        got = ops.matmul(aa, bb)
        torch.cuda.synchronize()
        want = ref.matmul_ref(aa, bb)
        assert (got.float() - want.float()).abs().max().item() <= \
            _mm_tol(aa, bb, aa.dtype)


# ---------------------------------------------------------------------------
# the routes of kernel #6 (int8) and of kernel #4 (CholeskyQR)
# ---------------------------------------------------------------------------

QD = kquant.Q8_DECODE_MAX_M
# (M, I, K, O, dtype, route): the decode route at one row, at 4 (every
# qwen2-0.5b site; the cluster split of I at mlp/down), at the threshold
# and at a ragged O, in both dtypes; the tensor-core route just above the
# threshold, at a prefill's 1,024 rows and at a ragged M; the fused kernel
# for f32 above the threshold, for widths that are not multiples of 16
# (Q8_SHAPES' I = 33, 257, K = 5, 40) and for a ragged O above it
Q8_ROUTE_CASES = [(1, 896, 256, 896, BF, "decode"),
                  (4, 896, 256, 896, BF, "decode"),
                  (4, 896, 128, 128, BF, "decode"),
                  (4, 896, 256, 4864, BF, "decode"),
                  (4, 4864, 256, 896, BF, "decode"),
                  (QD, 896, 256, 4864, BF, "decode"),
                  (3, 64, 32, 17, BF, "decode"),
                  (3, 96, 16, 48, F32, "decode"),
                  (QD, 4864, 256, 896, F32, "decode"),
                  (QD + 1, 896, 256, 896, BF, "tensor_core"),
                  (37, 96, 32, 48, BF, "tensor_core"),
                  (1024, 896, 256, 896, BF, "tensor_core"),
                  (1024, 896, 128, 128, BF, "tensor_core"),
                  (1024, 896, 256, 4864, BF, "tensor_core"),
                  (1024, 4864, 256, 896, BF, "tensor_core"),
                  (37, 896, 256, 896, F32, "fused"),
                  (4, 33, 5, 17, BF, "fused"),
                  (130, 257, 40, 129, BF, "fused"),
                  (64, 96, 32, 20, BF, "fused")]


@pytest.mark.cuda
@pytest.mark.parametrize("m,i,k,o,dtype,route", Q8_ROUTE_CASES)
def test_q8_routes_match_plain_version_and_repeat(cuda, m, i, k, o, dtype,
                                                  route):
    """Each route of ``lowrank_q8``: the rule picks it, a call counts one
    ``lowrank_q8`` whatever it launches, two calls give the same bits, and
    y is held to the plain version as ``test_q8_kernel_matches_plain_
    version`` holds it (the tensor-core route's two bf16 pieces of h sR add
    at most 2^-17 of each term, far inside that)."""
    x, rq, rs, lq, ls = _q8_inputs((m,), i, k, o, cuda, dtype, seed=m + i)
    assert kquant.q8_route(m, i, k, o, dtype, (x, rq, lq)) == route
    before = dict(ops.launch_counts())
    got = [kquant.lowrank_q8(x, rq, rs, lq, ls) for _ in range(2)]
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert after["lowrank_q8"] == before["lowrank_q8"] + 2
    assert all(after[n] == before[n] for n in after if n != "lowrank_q8")
    assert torch.equal(got[0], got[1])
    assert got[0].shape == (m, o) and got[0].dtype == dtype
    _close(got[0], ref.lowrank_q8_ref(x, rq, rs, lq, ls), i + k, dtype)


@pytest.mark.cuda
def test_q8_routes_refuse_cpu_tensors_before_any_build(cuda, monkeypatch):
    """A CPU operand at any route's shape raises in the wrapper's checks,
    before a library is built or loaded, and counts nothing."""
    from repro_torch.kernels import _build

    def no_build(source):
        raise AssertionError(f"built {source}")

    monkeypatch.setattr(_build, "library", no_build)
    before = dict(ops.launch_counts())
    for m, i, k, o, dtype, _ in Q8_ROUTE_CASES:
        x, rq, rs, lq, ls = _q8_inputs((m,), i, k, o, cuda, dtype)
        with pytest.raises(ValueError, match="CUDA tensors only"):
            kquant.lowrank_q8(x, rq, rs.cpu(), lq, ls)
    y = torch.randn(2, 64, 32, device=cuda)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        kqr.choleskyqr(y.cpu())
    assert ops.launch_counts() == before


@pytest.mark.cuda
@pytest.mark.parametrize("nt", [1, 2, 4])
@pytest.mark.parametrize("k", [16, 128, 256, 896])
def test_q8_decode_smem_formula_matches_the_source(cuda, nt, k):
    assert kquant._routes_lib().lowrank_q8_decode_smem_bytes(nt, k) == \
        lowrank.decode_smem_bytes(nt, k, kquant.Q8_SLICE)


# (B, M, K, dtype, (factor, apply)): the stacked sites of qwen2-0.5b (bf16:
# the blocked factor and the tensor-core apply; f32: the FMA apply), the
# ragged stacks of GRAM_SHAPES, the largest blocked rank, and two ranks
# above it on the global factor
QR_ROUTE_CASES = [(24, 896, 256, BF, ("blocked", "tensor_core")),
                  (24, 128, 128, BF, ("blocked", "tensor_core")),
                  (24, 4864, 256, BF, ("blocked", "tensor_core")),
                  (24, 896, 256, F32, ("blocked", "fma")),
                  (3, 100, 40, BF, ("blocked", "tensor_core")),
                  (3, 100, 40, F32, ("blocked", "fma")),
                  (2, 37, 5, BF, ("blocked", "fma")),
                  (2, 1000, 288, F32, ("blocked", "fma")),
                  (2, 1000, 296, F32, ("global", "fma")),
                  (1, 1000, 320, BF, ("global", "fma")),
                  # tinyllama-1.1b's refresh stacks: K = 512 takes the
                  # global factor, K = 128 the blocked one
                  (22, 2048, 512, BF, ("global", "fma")),
                  (22, 256, 128, BF, ("blocked", "tensor_core")),
                  (22, 5632, 512, BF, ("global", "fma"))]


@pytest.mark.cuda
@pytest.mark.parametrize("b,m,k,dtype,route", QR_ROUTE_CASES)
def test_choleskyqr_routes_match_plain_version_and_repeat(cuda, b, m, k,
                                                          dtype, route):
    """Each route of ``choleskyqr``: the rule picks it, a call counts one
    ``choleskyqr`` and one ``gram``, two calls give the same bits, and Q,
    mix and Q^T Q are held as ``test_choleskyqr_kernel_matches_plain_
    version`` holds them."""
    y = torch.randn(b, m, k, generator=torch.Generator().manual_seed(k))
    y = y.to(cuda, dtype)
    q0 = torch.empty_like(y)
    assert kqr.qr_route(k, dtype, (y, q0)) == route
    before = ops.launch_counts()
    got = [kqr.choleskyqr(y, with_retry=True) for _ in range(2)]
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert after["choleskyqr"] == before["choleskyqr"] + 2
    assert after["gram"] == before["gram"] + 2
    for a, c in zip(got[0], got[1]):
        assert torch.equal(a, c)
    q, mix, retried = got[0]
    assert not retried.any()
    want_q, want_mix = ref.choleskyqr_ref(y)
    qs = want_q.float().abs().max().item()
    tol_q = 1e-3 * qs if dtype == torch.float32 else 2 * 2.0 ** -7 * qs
    assert (q.float() - want_q.float()).abs().max().item() <= tol_q
    ms = want_mix.abs().max().item()
    assert (mix - want_mix).abs().max().item() <= 1e-3 * ms
    ortho = orthonormality_error(q).max().item()
    assert ortho <= (1e-3 if dtype == torch.float32 else 2.0 ** -7 * k)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [5, 32, 128, 256, 288])
def test_choleskyqr_blocked_smem_formula_matches_the_source(cuda, k):
    assert kqr._blocked_lib().choleskyqr_blocked_smem_bytes(k) == \
        kqr.blocked_smem_bytes(k)


# ---------------------------------------------------------------------------
# remat="block" on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("method", ["wsi", "wasi"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_remat_block_step_gradients_equal_none(cuda, method, dtype):
    """One training step's loss and gradients on tinyllama smoke under
    ``remat="block"`` and ``"none"``, from the same weights, ASI states and
    batch: the recompute relaunches every forward kernel (#2 and #7 twice
    a step, #3 once) on the same inputs, takes the same routes, and the
    kernels sum in a fixed order, so the gradients are bit-equal."""
    import dataclasses

    from repro_torch import api, configs
    from repro_torch.models import lm
    from repro_torch.train.step import value_and_grad

    base = configs.get_smoke("tinyllama-1.1b")
    b, s = 4, 64
    got = {}
    for remat in ("none", "block"):
        cfg = base.replace(remat=remat, dtype=str(dtype).split(".")[1],
                           wasi=dataclasses.replace(base.wasi,
                                                    method=method))
        api.install(api.resolve(cfg, batch=b, seq=s))
        model = lm.init_lm(cfg, device=cuda, seed=3)
        model.requires_grad_(True)
        states = (lm.init_lm_states(cfg, b, s, dtype=dtype, device=cuda,
                                    seed=3)
                  if cfg.wasi.compress_acts else None)
        g = torch.Generator().manual_seed(4)
        toks = torch.randint(0, cfg.vocab_size, (b, s + 1), generator=g)
        batch = {"tokens": toks[:, :-1].to(cuda),
                 "labels": toks[:, 1:].to(cuda)}
        ops.reset_launches()
        loss, _, grads, _ = value_and_grad(lm.lm_loss, model, batch, cfg,
                                           states)
        torch.cuda.synchronize()
        got[remat] = (loss, grads, ops.launch_counts())
    n, sites = base.n_layers, 7
    (l0, g0, c0), (l1, g1, c1) = got["none"], got["block"]
    assert c1["flash_attention"] == 2 * c0["flash_attention"] == 2 * n
    if method == "wsi":
        assert c1["lowrank_fwd_sketch"] == 2 * c0["lowrank_fwd_sketch"] \
            == 2 * sites * n
        assert c1["lowrank_bwd"] == c0["lowrank_bwd"] == sites * n
    assert torch.equal(l0, l1)
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["wsi", "wasi"])
@pytest.mark.parametrize("arch", ["zamba2-7b", "falcon-mamba-7b"])
def test_mamba_block_step_gradients_equal_none(cuda, arch, method):
    """One bf16 training step of zamba2 smoke (#8 with ``_SSDScan``'s
    plain backward) and falcon-mamba smoke (the plain selective scan,
    its chunks checkpointed inside the block's) under ``remat="block"``
    and ``"none"``: the recompute relaunches #8 (twice a layer under
    ``block``, once under ``none``, never in the backward), which gives
    the same bits twice, so loss and gradients are bit-equal."""
    import dataclasses

    from repro_torch import api, configs
    from repro_torch.models import lm
    from repro_torch.train.step import value_and_grad

    base = configs.get_smoke(arch)
    b, s = 2, 48
    got = {}
    for remat in ("none", "block"):
        cfg = base.replace(remat=remat, dtype="bfloat16",
                           wasi=dataclasses.replace(base.wasi,
                                                    method=method))
        api.install(api.resolve(cfg, batch=b, seq=s))
        model = lm.init_lm(cfg, device=cuda, seed=3)
        model.requires_grad_(True)
        states = (lm.init_lm_states(cfg, b, s, dtype=torch.bfloat16,
                                    device=cuda, seed=3)
                  if cfg.wasi.compress_acts else None)
        g = torch.Generator().manual_seed(4)
        toks = torch.randint(0, cfg.vocab_size, (b, s + 1), generator=g)
        batch = {"tokens": toks[:, :-1].to(cuda),
                 "labels": toks[:, 1:].to(cuda)}
        ops.reset_launches()
        loss, _, grads, _ = value_and_grad(lm.lm_loss, model, batch, cfg,
                                           states)
        torch.cuda.synchronize()
        got[remat] = (loss, grads, ops.launch_counts())
    (l0, g0, c0), (l1, g1, c1) = got["none"], got["block"]
    n_ssd = base.n_layers if arch == "zamba2-7b" else 0
    assert c0["ssd_scan"] == n_ssd and c1["ssd_scan"] == 2 * n_ssd
    assert torch.isfinite(l0) and torch.equal(l0, l1)
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["wsi", "wasi"])
def test_project_mode_step_on_the_card_matches_the_cpu(cuda, method):
    """The paper's project mode on tinyllama smoke (f32): the epsilon ranks
    calibrated on the card equal the CPU's (the f64 Gram's singular values
    on the card, f32 LAPACK on the CPU); one step of the same converted
    checkpoint (factorized once, on the CPU) and ASI states, SGD+momentum,
    on the card and on the CPU. The card launches #7 once a layer and no
    other kernel: the project-mode linears and the WSI step are plain, as
    in the reference. Loss within 1e-5 relative, W after the step within
    1e-5 of its scale, the WSI states' L R and the ASI factors within 1e-4
    of theirs (f32 sums in other orders; #7 takes f32 as exact bf16
    pieces)."""
    import dataclasses

    from repro_torch import api, configs
    from repro_torch.api import convert
    from repro_torch.api.bridge import from_reference
    from repro_torch.config import TrainConfig
    from repro_torch.models import lm
    from repro_torch.train.step import make_train_state, make_train_step

    base = configs.get_smoke("tinyllama-1.1b")
    dense_cfg = base.replace(wasi=dataclasses.replace(base.wasi,
                                                      method="none"))
    cfg = base.replace(wasi=dataclasses.replace(base.wasi, method=method,
                                                update_mode="project"))
    b, s = 4, 32
    dense = lm.init_lm(dense_cfg, device="cpu", seed=5)
    plan = api.install(api.resolve(cfg, batch=b, seq=s, calibration=dense))
    on_card = {k: torch.cat(v).to(cuda)
               for k, v in api.collect_linear_weights(dense).items()}
    card_plan = api.resolve(cfg, batch=b, seq=s, calibration=on_card)
    assert [sp.rank for sp in card_plan.specs] == \
        [sp.rank for sp in plan.specs]
    tree = convert.factorize(dense, plan)
    g = torch.Generator().manual_seed(6)
    toks = torch.randint(0, cfg.vocab_size, (b, s + 1), generator=g)
    tcfg = TrainConfig(optimizer="sgd", lr=0.05, momentum=0.9, steps=1)
    out = {}
    for dev in ("cpu", cuda):
        states = (lm.init_lm_states(cfg, b, s, device=dev, seed=7)
                  if cfg.wasi.compress_acts else None)
        state = make_train_state(from_reference(tree, cfg, dev), cfg, tcfg,
                                 asi_states=states)
        batch = {"tokens": toks[:, :-1].to(dev), "labels": toks[:, 1:].to(dev)}
        ops.reset_launches()
        state, m = make_train_step(lm.lm_loss, cfg, tcfg)(state, batch)
        if dev == cuda:
            torch.cuda.synchronize()
        out[dev] = (float(m["loss"]), state, ops.launch_counts())
    (l0, s0, c0), (l1, s1, c1) = out["cpu"], out[cuda]
    assert c0 == dict.fromkeys(c0, 0)
    assert c1 == dict(dict.fromkeys(c1, 0), flash_attention=cfg.n_layers)
    assert abs(l1 / l0 - 1) <= 1e-5

    def close(got, want, rel):
        got, want = got.detach().float().cpu(), want.detach().float()
        assert (got - want).abs().max() <= rel * want.abs().max()

    p0 = dict(s0.params.named_parameters())
    for k, v in s1.params.named_parameters():
        close(v, p0[k], 1e-5)
    for k, st in s0.wsi.items():
        close(s1.wsi[k].L @ s1.wsi[k].R, st.L @ st.R, 1e-4)
    if s0.asi is not None:
        a, c = [], []
        lm.map_states(a.append, s0.asi)
        lm.map_states(c.append, s1.asi)
        assert len(a) == len(c) > 0
        for x, y in zip(c, a):
            close(x, y, 1e-4)
