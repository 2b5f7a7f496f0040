"""The arithmetic of the redesigned routes of kernels #1 and #9, checked on
the CPU.

Kernel #1's serving forward takes one of three routes
(``lowrank.forward_route``); kernel #9 one of two
(``matmul_tiled.matmul_route``). Their CUDA kernels run only on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phases 3 and 11); here a
plain emulation of what each new route sums, and in which order, is held
against the plain versions (``ref.py``) at the main path's shapes and
against the reference's Pallas kernels in interpret mode at small ones:

* the decode route (``csrc/lowrank_decode.cu``): h = x R^T as partials over
  the reduction ranges of ``decode_plan`` (cluster ranks, then the warps of
  a block), summed in that fixed order; y = h L^T over the three bf16
  pieces of h. f32 operands enter as three bf16 pieces too, so every
  product is exact; each warp's partial is one f32 matmul here (the order
  of the tensor cores' sums inside it is the card's).
* the tensor-core route (``csrc/lowrank_sketch.cu`` without h): y over the
  first two bf16 pieces of h.
* #9's tensor-core route (``gemm_bf16.cuh`` with one piece): C as partials
  over the split ranges of ``gemm_plan``'s 64-deep steps, summed in order.

Tolerances, as ``chip_smoke.lowrank_tol`` and ``held`` state them: f32
sums of n terms in another order, 2 n eps max(scale, 1); a bf16 output
adds one rounding, 2^-7 of the scale.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import matmul as rmatmul
from repro.kernels import ops as rops
from repro_torch.kernels import lowrank as tlowrank
from repro_torch.kernels import ref as tref

torch.set_num_threads(1)
EPS32 = float(np.finfo(np.float32).eps)
BF16 = torch.bfloat16

# (I, K, O) of the serving sites: qwen2-0.5b's four and zamba2-7b's six
QWEN2 = {"attn/wq|wo": (896, 256, 896), "attn/wk|wv": (896, 128, 128),
         "mlp/gate|up": (896, 256, 4864), "mlp/down": (4864, 256, 896)}
ZAMBA2 = {"ssm/in_proj": (3584, 896, 14336), "ssm/bcdt_proj": (3584, 128, 240),
          "ssm/out_proj": (7168, 896, 3584), "attn/wq": (3584, 896, 3584),
          "mlp/down": (14336, 896, 3584)}


def _tol(n, want, bf16_out=False):
    scale = float(want.float().abs().max())
    tol = 2 * n * EPS32 * max(scale, 1.0)
    return tol + (2.0 ** -7 * scale if bf16_out else 0.0)


def _err(got, want):
    return float((got.float() - want.float()).abs().max())


def _inputs(m, i, k, o, dtype, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((m, i), np.float32))
    r = torch.from_numpy((rng.standard_normal((k, i)) * i ** -0.5)
                         .astype(np.float32))
    l_ = torch.from_numpy((rng.standard_normal((o, k)) * k ** -0.5)
                          .astype(np.float32))
    return x.to(dtype), r.to(dtype), l_.to(dtype)


def _pieces(t):
    """The bf16 pieces an operand enters the mma as: itself (bf16), or its
    three pieces (f32, exact)."""
    return [t] if t.dtype == BF16 else list(tref.split_pieces(t, 3))


def _skinny(b, a, lo, hi):
    """One warp's partial of out = B A^T over reduction columns [lo, hi):
    the f32 sum of every exact piece product, in the kernel's piece
    order."""
    out = 0
    for p in _pieces(b[:, lo:hi]):
        for q in _pieces(a[:, lo:hi]):
            out = out + p.float() @ q.float().T
    return out


def _ranges(n, parts):
    return [(p * n // parts, (p + 1) * n // parts) for p in range(parts)]


def emulate_decode(x, r, l_):
    """y in f32 (before its rounding) as the decode route sums it."""
    m, i = x.shape
    k, o = r.shape[0], l_.shape[0]
    plan = tlowrank.decode_plan(m, i, k, o)
    s = tlowrank.DECODE_SLICE
    slices = -(-i // s)
    h = torch.zeros(m, k)
    for c0, c1 in _ranges(slices, plan.cluster):          # cluster ranks
        tile = torch.zeros(m, k)
        for w0, w1 in _ranges(c1 - c0, plan.wk_h):          # warps of a block
            tile = tile + _skinny(x, r, (c0 + w0) * s, (c0 + w1) * s)
        h = h + tile
    y = torch.zeros(m, o)
    for w0, w1 in _ranges(-(-k // s), plan.wk_y):       # h enters as 3 pieces
        y = y + _skinny(h, l_, w0 * s, w1 * s)
    return y


def emulate_tensor_core(x, r, l_):
    """y in f32 of #1's tensor-core route: h = x R^T (one exact piece),
    y over h's first PIECES_BF16_OUT bf16 pieces."""
    h = x.float() @ r.float().T
    hp = tref.split_pieces(h, tlowrank.PIECES_BF16_OUT)
    return torch.cat(list(hp), dim=1).float() @ \
        torch.cat([l_.float().T] * len(hp), dim=0)


def emulate_matmul(a, b):
    """C in f32 of #9's tensor-core route: one exact bf16 piece, partials
    over ``gemm_plan``'s split ranges of 64-deep steps, summed in order."""
    m, k = a.shape
    plan = tlowrank.gemm_plan(m, b.shape[1], k)
    steps = -(-k // tlowrank.STEP)
    c = torch.zeros(m, b.shape[1])
    for s0, s1 in _ranges(steps, plan.splits):
        lo, hi = s0 * tlowrank.STEP, min(s1 * tlowrank.STEP, k)
        c = c + a[:, lo:hi].float() @ b[lo:hi].float()
    return c


# ---------------------------------------------------------------------------
# the decode route
# ---------------------------------------------------------------------------

# every serving site in bf16; f32 (the parity tier, run at small widths)
# at qwen2-0.5b's sites
DECODE_CASES = [(s, BF16) for s in list(QWEN2) + [f"z:{n}" for n in ZAMBA2]] \
    + [(s, torch.float32) for s in QWEN2]


@pytest.mark.parametrize("m", [1, 4, tlowrank.DECODE_MAX_M])
@pytest.mark.parametrize("site,dtype", DECODE_CASES)
def test_decode_route_sums_meet_the_plain_versions_tolerance(site, dtype, m):
    """At every serving site shape the decode route's partials, summed in
    the kernel's order over exact products, leave the f32 y within a
    quarter of the f32 tolerance (sums of I then K terms), and y rounded
    to the input dtype within the whole tolerance."""
    i, k, o = QWEN2[site] if site in QWEN2 else ZAMBA2[site[2:]]
    x, r, l_ = _inputs(m, i, k, o, dtype, seed=m + i + k)
    assert tlowrank.forward_route(m, i, k, o, dtype, (x, r, l_)) == "decode"
    y32 = emulate_decode(x, r, l_)
    want = tref.lowrank_matmul_ref(x, r, l_, out_dtype=torch.float32)
    assert _err(y32, want) <= _tol(i + k, want) / 4
    assert _err(y32.to(dtype), want) <= _tol(i + k, want, dtype == BF16)


@pytest.mark.parametrize("m,i,k,o", [(4, 96, 24, 48), (8, 128, 16, 64),
                                     (3, 64, 8, 32)])
@pytest.mark.parametrize("dtype", [BF16, torch.float32])
def test_decode_route_matches_the_pallas_kernel_in_interpret_mode(m, i, k, o,
                                                                  dtype):
    """The emulation against the reference's fused Pallas kernel on the
    same inputs (y sums I then K terms; bf16 adds one rounding on each
    side)."""
    x, r, l_ = _inputs(m, i, k, o, dtype, seed=7)
    jd = jnp.bfloat16 if dtype == BF16 else jnp.float32
    want = rops.lowrank_matmul_fused(
        *(jnp.asarray(t.float().numpy(), dtype=jd) for t in (x, r, l_)))
    want = torch.from_numpy(np.array(want, np.float32))
    got = emulate_decode(x, r, l_).to(dtype)
    assert _err(got, want) <= _tol(i + k, want, dtype == BF16)


def test_f32_operands_enter_as_exact_pieces():
    """Three bf16 pieces of each f32 operand: the piece products sum to
    the exact product of the two f32 values, so x R^T over pieces equals
    the float64 product up to the f32 sums' rounding."""
    x, r, _ = _inputs(4, 896, 256, 8, torch.float32, seed=3)
    got = _skinny(x, r, 0, 896)
    exact = x.double() @ r.double().T
    bound = 2 * 9 * 896 * EPS32 * float((x.abs() @ r.abs().T).max())
    assert float((got.double() - exact).abs().max()) <= bound


# ---------------------------------------------------------------------------
# kernel #1's tensor-core route
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("site", list(QWEN2) + [f"z:{n}" for n in ZAMBA2])
def test_tensor_core_route_meets_the_plain_versions_tolerance(site):
    """Two bf16 pieces of h: an error of at most 2^-17 of each term of
    h L^T, inside a quarter of the f32 tolerance, at a prefill's rows."""
    i, k, o = QWEN2[site] if site in QWEN2 else ZAMBA2[site[2:]]
    m = tlowrank.DECODE_MAX_M + 47
    x, r, l_ = _inputs(m, i, k, o, BF16, seed=i + o)
    assert tlowrank.forward_route(m, i, k, o, BF16, (x, r, l_)) == \
        "tensor_core"
    y32 = emulate_tensor_core(x, r, l_)
    want = tref.lowrank_matmul_ref(x, r, l_, out_dtype=torch.float32)
    assert _err(y32, want) <= _tol(i + k, want) / 4
    assert _err(y32.to(BF16), want) <= _tol(i + k, want, True)


@pytest.mark.parametrize("m,i,k,o", [(64, 96, 24, 48), (40, 128, 16, 64)])
def test_tensor_core_route_matches_the_pallas_kernel_in_interpret_mode(
        m, i, k, o):
    x, r, l_ = _inputs(m, i, k, o, BF16, seed=9)
    want = rops.lowrank_matmul_fused(
        *(jnp.asarray(t.float().numpy(), dtype=jnp.bfloat16)
          for t in (x, r, l_)))
    want = torch.from_numpy(np.array(want, np.float32))
    got = emulate_tensor_core(x, r, l_).to(BF16)
    assert _err(got, want) <= _tol(i + k, want, True)


# ---------------------------------------------------------------------------
# kernel #9's tensor-core route
# ---------------------------------------------------------------------------

def _mm_bound(a, b, bf16_out, scale):
    """tests/test_torch_matmul.py's bound: 2 K eps (|A| |B|).max(), plus
    one bf16 rounding (2^-7 of the scale) for a bf16 output."""
    tol = 2 * a.shape[1] * EPS32 * max(
        float((a.float().abs() @ b.float().abs()).max()), 1.0)
    return tol + (2.0 ** -7 * scale if bf16_out else 0.0)


# (M, K, N): the two-launch pair's products at decode and training rows,
# split and unsplit plans, and ragged M
MM_SHAPES = [(4, 896, 256), (4, 256, 4864), (4, 4864, 256), (2048, 896, 256),
             (2048, 256, 4864), (1000, 896, 4864), (33, 264, 136)]


@pytest.mark.parametrize("m,k,n", MM_SHAPES)
def test_matmul_route_sums_meet_the_plain_versions_tolerance(m, k, n):
    """#9's partials over ``gemm_plan``'s ranges, summed in order, against
    the plain product: within the f32 bound, and rounded to bf16 within
    the bf16 one."""
    rng = np.random.default_rng(m + k + n)
    a = torch.from_numpy(rng.standard_normal((m, k), np.float32)).to(BF16)
    b = torch.from_numpy(rng.standard_normal((k, n), np.float32)).to(BF16)
    c32 = emulate_matmul(a, b)
    want = tref.matmul_ref(a, b, torch.float32)
    assert _err(c32, want) <= _mm_bound(a, b, False, 0.0)
    assert _err(c32.to(BF16), want) <= _mm_bound(
        a, b, True, float(want.abs().max()))


@pytest.mark.parametrize("m,k,n", [(33, 264, 136), (4, 256, 64),
                                   (130, 72, 40)])
def test_matmul_route_matches_the_pallas_kernel_in_interpret_mode(m, k, n):
    rng = np.random.default_rng(k)
    a = torch.from_numpy(rng.standard_normal((m, k), np.float32)).to(BF16)
    b = torch.from_numpy(rng.standard_normal((k, n), np.float32)).to(BF16)
    want = rmatmul(jnp.asarray(a.float().numpy(), dtype=jnp.bfloat16),
                   jnp.asarray(b.float().numpy(), dtype=jnp.bfloat16))
    want = torch.from_numpy(np.array(want, np.float32))
    got = emulate_matmul(a, b).to(BF16)
    assert _err(got, want) <= _mm_bound(a, b, True, float(want.abs().max()))
