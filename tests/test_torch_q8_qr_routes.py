"""The arithmetic of the redesigned routes of kernels #6 (int8 low-rank
forward) and #4 (CholeskyQR), checked on the CPU.

Kernel #6 takes one of three routes (``quant.q8_route``), kernel #4 one of
two factors and two applies (``qr.qr_route``). Their CUDA kernels run only
on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py`` phases 6 and
9); here the route rules are pinned, and a plain emulation of what each
new route sums, and in which order, is held against the plain versions
(``ref.py``) at the main path's shapes and against the reference's Pallas
kernels in interpret mode at small ones:

* #6's decode route (``csrc/lowrank_q8_routes.cu`` on
  ``csrc/lowrank_decode.cuh``): int8 factors converted exactly to bf16
  (the kernel's bit trick, emulated in numpy); h as partials over the
  64-deep slices of ``decode_plan``'s cluster ranks and warps, summed in
  that order, then scaled by sR; y over the three bf16 pieces of h, scaled
  by sL;
* #6's tensor-core route: h = x Rq^T (one exact piece) scaled by sR, then
  its two bf16 pieces; y = sum_p h_p Lq^T over ``sketch_plan``'s split
  ranges, scaled by sL;
* #4's blocked route (``csrc/choleskyqr_blocked.cu``): the shift from the
  kernel's tree sum of the trace; a right-looking blocked Cholesky of 32 x
  32 blocks (the diagonal block column by column with the guards, the
  panel by substitution against it, the trailing update), the inverses of
  the diagonal blocks, then the triangular inverse from the last block
  column back, the shift ladder; the apply over two bf16 pieces of X for
  bf16 Y.

Each block or warp partial is one f32 matmul here: the order of the
card's sums inside it is its own. Tolerances as ``chip_smoke.py`` states
them: f32 sums of n terms in another order, 2 n eps max(scale, 1), a bf16
output one rounding more (2^-7 of the scale); CholeskyQR's Q and mix 1e-3
of their scale (the Cholesky amplifies the Gram's rounding by its
condition number).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.qr import choleskyqr_tiled
from repro.kernels.quant import lowrank_q8_tiled
from repro_torch.core.orthogonal import cholesky_qr_mix_ref
from repro_torch.kernels import _build, ops
from repro_torch.kernels import lowrank as tlowrank
from repro_torch.kernels import qr as tqr
from repro_torch.kernels import quant as tquant
from repro_torch.kernels import ref as tref
from repro_torch.quant import quantize_tensor

torch.set_num_threads(1)
EPS32 = float(np.finfo(np.float32).eps)
BF16, F32 = torch.bfloat16, torch.float32
QD = tquant.Q8_DECODE_MAX_M

# qwen2-0.5b's serving sites (I, K, O) and its stacked refresh operands
QWEN2 = {"attn/wq|wo": (896, 256, 896), "attn/wk|wv": (896, 128, 128),
         "mlp/gate|up": (896, 256, 4864), "mlp/down": (4864, 256, 896)}
STACKS = {"attn/wq|wo": (24, 896, 256), "attn/wk|wv": (24, 128, 128),
          "mlp/gate|up": (24, 4864, 256), "mlp/down": (24, 896, 256)}


def _tol(n, want, bf16_out=False):
    scale = float(want.float().abs().max())
    tol = 2 * n * EPS32 * max(scale, 1.0)
    return tol + (2.0 ** -7 * scale if bf16_out else 0.0)


def _err(got, want):
    return float((got.float() - want.float()).abs().max())


def _q8_inputs(m, i, k, o, dtype, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((m, i), np.float32)).to(dtype)
    rq, rs = quantize_tensor(torch.from_numpy(
        (rng.standard_normal((k, i)) * i ** -0.5).astype(np.float32)))
    lq, ls = quantize_tensor(torch.from_numpy(
        (rng.standard_normal((o, k)) * k ** -0.5).astype(np.float32)))
    return x, rq, rs, lq, ls


def _ranges(n, parts):
    return [(p * n // parts, (p + 1) * n // parts) for p in range(parts)]


# ---------------------------------------------------------------------------
# the route rules
# ---------------------------------------------------------------------------

def _aligned(*shapes, dtype=BF16):
    return tuple(torch.empty(s, dtype=dtype) for s in shapes)


@pytest.mark.parametrize("site", list(QWEN2))
@pytest.mark.parametrize("m,dtype,route", [
    (1, BF16, "decode"), (4, BF16, "decode"), (QD, BF16, "decode"),
    (4, F32, "decode"), (QD, F32, "decode"), (QD + 1, BF16, "tensor_core"),
    (37, BF16, "tensor_core"), (1024, BF16, "tensor_core"),
    (QD + 1, F32, "fused"), (1024, F32, "fused")])
def test_q8_route_at_the_qwen2_sites(site, m, dtype, route):
    i, k, o = QWEN2[site]
    x, rq, lq = _aligned((m, i), (k, i), (o, k))
    assert tquant.q8_route(m, i, k, o, dtype, (x, rq, lq)) == route


@pytest.mark.parametrize("m,i,k,o,dtype,route", [
    # Q8_SHAPES' ragged widths: I = 33, 257 and K = 5, 40 (not multiples
    # of 16) take the fused kernel at every M
    (4, 16, 4, 24, BF16, "fused"), (7, 33, 5, 17, BF16, "fused"),
    (130, 257, 40, 129, BF16, "fused"), (4, 257, 40, 129, F32, "fused"),
    # multiples of 16 at the boundaries: I = K = 16; I a multiple of 8 only
    (QD, 16, 16, 8, BF16, "decode"), (QD + 1, 16, 16, 8, BF16, "tensor_core"),
    (4, 24, 16, 8, BF16, "fused"), (4, 32, 24, 8, BF16, "fused"),
    # O is free on the decode route (its stores are scalar), a multiple of
    # 8 on the tensor cores' paired stores
    (4, 64, 32, 17, BF16, "decode"), (64, 96, 32, 20, BF16, "fused"),
    (64, 96, 32, 24, BF16, "tensor_core")])
def test_q8_route_at_ragged_shapes_and_boundaries(m, i, k, o, dtype, route):
    x, rq, lq = _aligned((m, i), (k, i), (o, k))
    assert tquant.q8_route(m, i, k, o, dtype, (x, rq, lq)) == route


def test_q8_route_sends_misaligned_bases_to_the_fused_kernel():
    """A base that is not 16-byte aligned (a view 2 bytes in) cannot take
    the 16-byte loads of either new route."""
    i, k, o = QWEN2["attn/wq|wo"]
    for m in (4, 64):
        x = torch.empty(m * i + 8, dtype=BF16)[1:1 + m * i].view(m, i)
        rq, lq = _aligned((k, i), (o, k))
        assert x.data_ptr() % 16 == 2
        assert tquant.q8_route(m, i, k, o, BF16, (x, rq, lq)) == "fused"


def test_q8_decode_threshold_and_plan():
    """The sweep's threshold (two n8 tiles cover it), and the decode
    route's plan with 64-deep slices: the cluster split of I at mlp/down
    keeps >= 2 slices a warp, and the staged bytes take the 64-deep
    slice's row pad (8)."""
    assert QD == 16 and tlowrank.n8_tiles(QD) == 2
    assert tquant.Q8_SLICE == 64
    assert tlowrank.decode_plan(4, 4864, 256, 896, 64) == \
        tlowrank.DecodePlan(1, 8, 4, 8)
    assert tlowrank.decode_plan(4, 896, 256, 4864, 64) == \
        tlowrank.DecodePlan(1, 8, 1, 4)
    assert tlowrank.decode_smem_bytes(1, 256, 64) == 3 * 8 * (256 + 8) * 2
    assert tlowrank.decode_smem_bytes(1, 256) == 3 * 8 * (256 + 32) * 2


@pytest.mark.parametrize("k,dtype,route", [
    (128, BF16, ("blocked", "tensor_core")),
    (256, BF16, ("blocked", "tensor_core")),
    (256, F32, ("blocked", "fma")), (128, F32, ("blocked", "fma")),
    (40, BF16, ("blocked", "tensor_core")), (5, BF16, ("blocked", "fma")),
    (36, BF16, ("blocked", "fma")), (288, BF16, ("blocked", "tensor_core")),
    (289, BF16, ("global", "fma")), (296, F32, ("global", "fma")),
    (896, BF16, ("global", "fma"))])
def test_qr_route_pins_the_rank_rule(k, dtype, route):
    """K <= 288 (the packed lower triangle of 32 x 32 f32 blocks and the
    diagonal inverses fit one block's 227 KB) takes the blocked factor;
    bf16 with K a multiple of 8 the tensor-core apply."""
    y, q = _aligned((3, 40, k), (3, 40, k), dtype=dtype)
    assert tqr.qr_route(k, dtype, (y, q)) == route


def test_qr_blocked_smem_and_misaligned_apply():
    assert tqr.blocked_smem_bytes(256) == 44 * 32 * 33 * 4 == 185856
    assert tqr.blocked_smem_bytes(128) == 14 * 32 * 33 * 4
    assert tqr.blocked_smem_bytes(288) + tqr.BLOCKED_STATIC_SMEM <= \
        tlowrank.SMEM_LIMIT < tqr.blocked_smem_bytes(289)
    y = torch.empty(40 * 256 + 8, dtype=BF16)[1:1 + 40 * 256].view(40, 256)
    assert tqr.qr_route(256, BF16, (y,)) == ("blocked", "fma")
    # the apply's plan: the stack's tiles count together
    assert tlowrank.gemm_plan(896, 256, 256, 2, batch=24) == \
        tlowrank.GemmPlan(128, 1)
    assert tlowrank.gemm_plan(128, 128, 128, 2, batch=24) == \
        tlowrank.GemmPlan(64, 1)
    assert tlowrank.gemm_plan(128, 128, 128, 2) == tlowrank.GemmPlan(64, 1)


def test_cpu_tensors_raise_before_any_build(monkeypatch):
    """The wrappers of #6 and #4 refuse CPU tensors in their checks,
    before a library is built or loaded, and count nothing."""
    def no_build(source):
        raise AssertionError(f"built {source}")

    monkeypatch.setattr(_build, "library", no_build)
    before = dict(ops.launch_counts())
    for m in (4, 1024):
        x, rq, rs, lq, ls = _q8_inputs(m, 896, 256, 896, BF16, seed=m)
        with pytest.raises(ValueError, match="CUDA tensors only"):
            tquant.lowrank_q8(x, rq, rs, lq, ls)
    for k in (256, 896):
        with pytest.raises(ValueError, match="CUDA tensors only"):
            tqr.choleskyqr(torch.randn(2, 300, k))
    assert ops.launch_counts() == before


# ---------------------------------------------------------------------------
# kernel #6: the int8 conversion and the two routes' sums
# ---------------------------------------------------------------------------

def i8_to_bf16_bits(q: np.ndarray) -> np.ndarray:
    """The kernel's conversion (gemm_bf16.cuh ``i8x4_bf16``): flip the
    sign bit, place the byte in the f32 2^23 + u, subtract 2^23 + 128,
    keep the high 16 bits."""
    u = (q.view(np.uint8) ^ 0x80).astype(np.uint32)
    f = (u | np.uint32(0x4B000000)).view(np.float32) - np.float32(8388736.0)
    return (f.view(np.uint32) >> 16).astype(np.uint16)


def test_int8_converts_exactly_to_bf16():
    """Every int8 value: the kernel's bit trick gives exactly the bf16 of
    the value, and that bf16 is the value (7 significand bits suffice)."""
    q = np.arange(-128, 128, dtype=np.int32).astype(np.int8)
    bits = i8_to_bf16_bits(q)
    want = torch.from_numpy(q.astype(np.float32)).to(BF16)
    assert np.array_equal(bits, want.view(torch.int16).numpy().view(np.uint16))
    back = torch.from_numpy(bits.view(np.int16)).view(BF16).float()
    assert torch.equal(back, torch.from_numpy(q.astype(np.float32)))


def _as_bf16(q: torch.Tensor) -> torch.Tensor:
    """An int8 factor as the mma sees it: bf16 by the kernel's trick."""
    bits = i8_to_bf16_bits(q.numpy())
    return torch.from_numpy(bits.view(np.int16)).view(BF16)


def _pieces(t):
    return [t] if t.dtype == BF16 else list(tref.split_pieces(t, 3))


def _skinny(b, a, lo, hi):
    """One warp's partial of B A^T over columns [lo, hi): every exact
    piece product, f32 sums, in the kernel's piece order."""
    out = 0
    for p in _pieces(b[:, lo:hi]):
        for q in _pieces(a[:, lo:hi]):
            out = out + p.float() @ q.float().T
    return out


def emulate_q8_decode(x, rq, rs, lq, ls):
    """y in f32 (before its rounding) as the decode route sums it."""
    m, i = x.shape
    k, o = rq.shape[0], lq.shape[0]
    plan = tlowrank.decode_plan(m, i, k, o, tquant.Q8_SLICE)
    s = tquant.Q8_SLICE
    r16, l16 = _as_bf16(rq), _as_bf16(lq)
    h = torch.zeros(m, k)
    for c0, c1 in _ranges(-(-i // s), plan.cluster):       # cluster ranks
        tile = torch.zeros(m, k)
        for w0, w1 in _ranges(c1 - c0, plan.wk_h):          # warps of a block
            tile = tile + _skinny(x, r16, (c0 + w0) * s, (c0 + w1) * s)
        h = h + tile
    h = h * rs                                   # sR after the rank sum
    y = torch.zeros(m, o)
    for w0, w1 in _ranges(-(-k // s), plan.wk_y):       # h as 3 pieces
        y = y + _skinny(h, l16, w0 * s, w1 * s)
    return y * ls


def emulate_q8_tensor_core(x, rq, rs, lq, ls):
    """y in f32 of the tensor-core route: h sR over one exact piece, its
    two bf16 pieces, y = sum_p h_p Lq^T over sketch_plan's split ranges of
    64-deep steps (pieces concatenated along the reduction), times sL."""
    m, i = x.shape
    k, o = rq.shape[0], lq.shape[0]
    plan = tlowrank.sketch_plan(m, i, k, o)
    hs = (x.float() @ _as_bf16(rq).float().T) * rs
    hp = tref.split_pieces(hs, tlowrank.PIECES_BF16_OUT)
    a = torch.cat(list(hp), dim=1).float()
    b = torch.cat([_as_bf16(lq).float().T] * len(hp), dim=0)
    steps = -(-k // tlowrank.STEP)
    total = len(hp) * steps
    y = torch.zeros(m, o)
    for t0, t1 in _ranges(total, plan.y.splits):
        part = 0
        for t in range(t0, t1):
            p, k0 = divmod(t, steps)
            lo = p * k + k0 * tlowrank.STEP
            hi = p * k + min(k, (k0 + 1) * tlowrank.STEP)
            part = part + a[:, lo:hi] @ b[lo:hi]
        y = y + part
    return y * ls


DECODE_CASES = [(s, BF16) for s in QWEN2] + [(s, F32) for s in QWEN2]


@pytest.mark.parametrize("m", [1, 4, QD])
@pytest.mark.parametrize("site,dtype", DECODE_CASES)
def test_q8_decode_route_sums_meet_the_plain_versions_tolerance(site, dtype,
                                                                m):
    """At every qwen2-0.5b site the decode route's partials, summed in the
    kernel's order over exact products, leave the f32 y within a quarter
    of the f32 tolerance (sums of I then K terms), and y rounded to the
    input dtype within the whole tolerance."""
    i, k, o = QWEN2[site]
    x, rq, rs, lq, ls = _q8_inputs(m, i, k, o, dtype, seed=m + i + k)
    assert tquant.q8_route(m, i, k, o, dtype, (x, rq, lq)) == "decode"
    y32 = emulate_q8_decode(x, rq, rs, lq, ls)
    want = tref.lowrank_q8_ref(x.float(), rq, rs, lq, ls)
    assert _err(y32, want) <= _tol(i + k, want) / 4
    assert _err(y32.to(dtype), want) <= _tol(i + k, want, dtype == BF16)


@pytest.mark.parametrize("site", list(QWEN2))
def test_q8_tensor_core_route_meets_the_plain_versions_tolerance(site):
    """Two bf16 pieces of h sR: at most 2^-17 of each term of h Lq^T,
    inside a quarter of the f32 tolerance, at a prefill's rows."""
    i, k, o = QWEN2[site]
    m = 300
    x, rq, rs, lq, ls = _q8_inputs(m, i, k, o, BF16, seed=i + o)
    assert tquant.q8_route(m, i, k, o, BF16, (x, rq, lq)) == "tensor_core"
    y32 = emulate_q8_tensor_core(x, rq, rs, lq, ls)
    want = tref.lowrank_q8_ref(x.float(), rq, rs, lq, ls)
    assert _err(y32, want) <= _tol(i + k, want) / 4
    assert _err(y32.to(BF16), want) <= _tol(i + k, want, True)


def _pallas_q8(x, rq, rs, lq, ls):
    jd = jnp.bfloat16 if x.dtype == BF16 else jnp.float32
    y = lowrank_q8_tiled(jnp.asarray(x.float().numpy(), dtype=jd),
                         jnp.asarray(rq.numpy().T), jnp.asarray(rs.numpy()),
                         jnp.asarray(lq.numpy().T), jnp.asarray(ls.numpy()),
                         interpret=True)
    return torch.from_numpy(np.array(y, np.float32))


@pytest.mark.parametrize("m,i,k,o,dtype,route", [
    (4, 128, 32, 48, BF16, "decode"), (3, 64, 16, 17, F32, "decode"),
    (8, 256, 64, 40, BF16, "decode"), (64, 128, 32, 48, BF16, "tensor_core"),
    (40, 96, 48, 64, BF16, "tensor_core")])
def test_q8_routes_match_the_pallas_kernel_in_interpret_mode(m, i, k, o,
                                                             dtype, route):
    """The emulations against the reference's int8 Pallas kernel on the
    same inputs (y sums I then K terms; bf16 adds one rounding on each
    side)."""
    x, rq, rs, lq, ls = _q8_inputs(m, i, k, o, dtype, seed=11)
    assert tquant.q8_route(m, i, k, o, dtype, (x, rq, lq)) == route
    emulate = emulate_q8_decode if route == "decode" else \
        emulate_q8_tensor_core
    got = emulate(x, rq, rs, lq, ls).to(dtype)
    want = _pallas_q8(x, rq, rs, lq, ls)
    assert _err(got, want) <= _tol(i + k, want, dtype == BF16)


# ---------------------------------------------------------------------------
# kernel #4: the blocked factor, its inverse, the ladder, the apply
# ---------------------------------------------------------------------------

B_ = tqr.BLOCK


def kernel_shift(g: torch.Tensor, shift: float) -> torch.Tensor:
    """shift * max(tr(G) / K, 1e-30) from the kernel's tree sum: thread t
    of 256 sums G[i, i] for i = t mod 256 in order, then halves pair up."""
    k = g.shape[-1]
    red = torch.zeros(256)
    for i in range(k):
        red[i % 256] = red[i % 256] + g[i, i]
    s = 128
    while s > 0:
        red[:s] = red[:s] + red[s:2 * s]
        s //= 2
    return torch.tensor(shift, dtype=F32) * torch.clamp(
        red[0] / torch.tensor(k, dtype=F32), min=1e-30)


def _chol_diag(s: torch.Tensor, nvalid: int):
    """Warp 0's Cholesky of a 32-block, column by column with the guard;
    whether a real pivot was not positive."""
    a = s.clone()
    bad = False
    for c in range(B_):
        piv = a[c, c].clone()
        bad |= c < nvalid and not bool(piv > 0)
        d = torch.sqrt(torch.clamp(piv, min=1e-30))
        col = torch.where(torch.arange(B_) >= c, a[:, c] / d, 0.0)
        a[:, c] = col
        a[:, c + 1:] -= col[:, None] * col[None, c + 1:]
    return torch.tril(a), bad


def _inv_diag(c: torch.Tensor) -> torch.Tensor:
    """Forward substitution by rows with the guard max(c_ii, 1e-30)."""
    x = torch.zeros(B_, B_)
    for i in range(B_):
        x[i] = (torch.eye(B_)[i] - c[i, :i] @ x[:i]) / \
            torch.clamp(c[i, i], min=1e-30)
    return x


def emulate_blocked_factor(g: torch.Tensor, shift: float):
    """(X = C^-1, retried) of one stack index as the blocked route takes
    them, in its block order."""
    k = g.shape[-1]
    nb = -(-k // B_)
    sh = kernel_shift(g, shift)
    for attempt in (0, 1):
        a = torch.eye(nb * B_)
        a[:k, :k] = g + (sh if attempt == 0 else 1e4 * sh) * torch.eye(k)
        blk = {(i, j): a[i * B_:(i + 1) * B_, j * B_:(j + 1) * B_].clone()
               for i in range(nb) for j in range(i + 1)}
        failed = False
        for j in range(nb):
            blk[j, j], bad = _chol_diag(blk[j, j], min(B_, k - j * B_))
            failed |= bad
            if failed and attempt == 0:
                break
            for i in range(j + 1, nb):       # C_ij = A_ij C_jj^-T
                blk[i, j] = torch.linalg.solve_triangular(
                    blk[j, j], blk[i, j].T, upper=False).T
            for i in range(j + 1, nb):
                for kk in range(j + 1, i + 1):
                    blk[i, kk] = blk[i, kk] - blk[i, j] @ blk[kk, j].T
        if not (failed and attempt == 0):
            break
    retried = attempt == 1
    dinv = {j: _inv_diag(blk[j, j]) for j in range(nb)}
    for j in range(nb - 2, -1, -1):
        t = {i: sum(((dinv[i] if kk == i else blk[i, kk]) @ blk[kk, j]
                     for kk in range(j + 1, i + 1)), torch.zeros(B_, B_))
             for i in range(j + 1, nb)}
        for i in range(j + 1, nb):
            blk[i, j] = -(t[i] @ dinv[j])
    x = torch.zeros(nb * B_, nb * B_)
    for i in range(nb):
        for j in range(i + 1):
            x[i * B_:(i + 1) * B_, j * B_:(j + 1) * B_] = \
                dinv[i] if i == j else blk[i, j]
    return x[:k, :k], retried


def emulate_choleskyqr(y: torch.Tensor, shift: float = 1e-6):
    """(Q, mix, retried) of a stack as the blocked route computes them:
    the Gram, the factor per index, mix = X G, and Q = Y X^T over two
    bf16 pieces of X for bf16 Y (X^T in f32 otherwise)."""
    yf = y.float()
    g = yf.mT @ yf
    xs, flags = zip(*(emulate_blocked_factor(gi, shift) for gi in g))
    x = torch.stack(xs)
    mix = x @ g
    if y.dtype == BF16:
        xp = tref.split_pieces(x, tlowrank.PIECES_BF16_OUT)
        q = sum(yf @ p.float().mT for p in xp)
    else:
        q = yf @ x.mT
    return q.to(y.dtype), mix, torch.tensor(flags)


def _well_conditioned(b, m, k, seed):
    """(b, m, k) with orthonormal columns scaled by 0.5-2 (cond <= 4), as
    chip_smoke.well_conditioned draws a site's stacked L."""
    rng = np.random.default_rng(seed)
    q = np.linalg.qr(rng.standard_normal((b, m, k)))[0]
    s = 0.5 + 1.5 * rng.random((b, 1, k))
    return torch.from_numpy((q * s).astype(np.float32))


def _check_qr(got, want, dtype):
    q, mix = got[:2]
    wq, wmix = want[:2]
    qs, ms = float(wq.float().abs().max()), float(wmix.abs().max())
    tol_q = 1e-3 * qs + (2.0 ** -7 * qs if dtype == BF16 else 0.0)
    assert _err(q, wq) <= tol_q
    assert _err(mix, wmix) <= 1e-3 * ms


@pytest.mark.parametrize("site", list(STACKS))
@pytest.mark.parametrize("dtype", [BF16, F32])
def test_blocked_choleskyqr_meets_the_plain_version_at_the_stacks(site,
                                                                  dtype):
    """The blocked factor, inverse and apply on a site's stacked operand
    (4 of its 24 indices) against the plain version (the ladder's
    Cholesky and two triangular solves), within chip_smoke's limits; no
    index retries."""
    b, m, k = STACKS[site]
    y = _well_conditioned(4, m, k, seed=k + m).to(dtype)
    assert tqr.qr_route(k, dtype, (y,))[0] == "blocked"
    got = emulate_choleskyqr(y)
    want = tref.choleskyqr_ref(y, with_retry=True)
    assert not got[2].any() and not want[2].any()
    _check_qr(got, want, dtype)


@pytest.mark.parametrize("m,k", [(100, 40), (37, 5), (300, 128)])
def test_blocked_choleskyqr_matches_the_pallas_kernel_in_interpret_mode(m,
                                                                        k):
    """The emulation against the reference's fused Pallas CholeskyQR (one
    2-D operand, f32). The Pallas kernel spreads the shift's trace over K
    padded to 128 where K is not a multiple of it; at these well-
    conditioned operands that moves nothing past the 1e-3 limit."""
    y = _well_conditioned(1, m, k, seed=m)[0]
    q, mix = choleskyqr_tiled(jnp.asarray(y.numpy()), interpret=True)
    want = (torch.from_numpy(np.array(q)), torch.from_numpy(np.array(mix)))
    got = emulate_choleskyqr(y[None])
    _check_qr((got[0][0], got[1][0]), want, F32)


def _spiked(m, k, seed):
    """Y = U diag(s) V^T with one singular value 1 and k - 1 of 1e-5
    (chip_smoke.ladder_case): the first shifted Cholesky of its Gram
    fails."""
    rng = np.random.default_rng(seed)
    u = np.linalg.qr(rng.standard_normal((m, k)))[0]
    v = np.linalg.qr(rng.standard_normal((k, k)))[0]
    s = np.full(k, 1e-5)
    s[0] = 1.0
    return ((u * s) @ v.T).astype(np.float32)


def test_blocked_ladder_retries_where_the_plain_ladder_does():
    """A stack of a well-conditioned and an ill-conditioned (896, 256)
    operand, as phase 6's ladder case: the blocked factor retries at index
    1 only, exactly where ``cholesky_qr_mix_ref`` does, and then agrees
    with it within 1e-3 of the scale of Q and mix."""
    y = torch.stack([_well_conditioned(1, 896, 256, seed=13)[0],
                     torch.from_numpy(_spiked(896, 256, 13))])
    got = emulate_choleskyqr(y)
    want = cholesky_qr_mix_ref(y, with_retry=True)
    assert want[2].tolist() == [False, True]
    assert got[2].tolist() == want[2].tolist()
    for j in range(2):
        _check_qr((got[0][j], got[1][j]), (want[0][j], want[1][j]), F32)


def test_blocked_factor_inverts_the_shifted_gram():
    """X from the blocked order is C^-1 for the shifted Gram's Cholesky:
    X (G + s I) X^T = I within f32 rounding of a cond <= 16 Gram, with
    zeros above the diagonal and the identity pad cut away at a ragged K."""
    for k in (40, 256):
        y = _well_conditioned(1, 300, k, seed=k)[0]
        g = y.mT @ y
        x, retried = emulate_blocked_factor(g, 1e-6)
        assert not retried
        assert torch.equal(x, torch.tril(x))
        gs = g + kernel_shift(g, 1e-6) * torch.eye(k)
        assert _err(x @ gs @ x.T, torch.eye(k)) <= 1e-4
