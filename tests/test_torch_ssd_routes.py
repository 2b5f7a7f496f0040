"""Kernel #8's routes on the CPU: the rule ``ssd_route`` at the main path's
shapes and at its edges, and an emulation of the tensor-core route
(``kernels/csrc/ssd_scan_tc.cu``) in the kernel's order, held against the
plain version ``ref.ssd_scan_ref``, the reference's ``_ssd_chunked`` and
its Pallas kernel ``ssd_scan_tiled`` (interpret mode) on the same numpy
inputs; why the route splits each f32 operand into 2 bf16 pieces; and
that a bf16 Mamba-2 mixer feeds the scan its u, B and C as stored, with
the same bits on the CPU as when it cast them to f32 itself.

The emulation follows the kernel's three launches: C B^T once per (batch,
chunk) (bf16 products, exact in f32); each head's chunk-local state S_c =
(u^T diag(w)) B with w_j = dt_j exp(cum_Q - cum_j), the weighted u split
into pieces; the state pass, which stores each chunk's incoming state as
pieces; and the outputs exp(cum_i) C S_prev^T (skipped in chunk 0) + G u,
G = (C B^T) exp(cum_i - cum_j) dt_j (j <= i) split into pieces. Decays are
exp2 with log2(e) folded into cum, as in the kernel. Pieces enter as the
f32 value they sum to (exact for up to 3 bf16 pieces), so each product is
the kernel's exact bf16 x bf16 sum.

Tolerances, of the output's scale (its largest magnitude, at least 1):
1e-5 at the reference's chunks (8-37), as ``tests/test_torch_mamba.py``
holds the plain version to ``_ssd_chunked``; at zamba2's chunk of 256 the
prefix sums of dt A reach magnitudes of ~300, whose f32 rounding moves the
decays by ~1e-5 in any evaluation order (the plain version and
``_ssd_chunked`` themselves differ by up to 3.5e-5 of the scale on these
inputs), so there it is ``ssd_tol``'s 1e-4, what the card is held to
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 16).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.nn.mamba as rmamba
import repro_torch.configs as tconfigs
import repro_torch.nn.mamba as tmamba
from repro.kernels.ssd_scan import ssd_scan_tiled
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd_scan as kssd
from repro_torch.kernels.lowrank import SMEM_LIMIT

torch.set_num_threads(1)
BF, F32 = torch.bfloat16, torch.float32
LOG2E = 1.4426950408889634
FINE, SSD_TOL = 1e-5, 1e-4   # of the output's scale


# ---------------------------------------------------------------------------
# the route rule
# ---------------------------------------------------------------------------

def _operands(bz, s, h, dh, n, dtype, *, bc_width=None, offset=0):
    """u (bz, s, h, dh) and B, C as the mixer makes them: row views of
    one (bz, s, bc_width) tensor (2 n wide unless given), B starting at
    element ``offset``. Allocated, never written: the rule reads only
    dtypes, shapes, strides and addresses."""
    u = torch.empty(bz, s, h, dh, dtype=dtype)
    width = bc_width or 2 * n
    bc = torch.empty(bz, s, width + offset, dtype=dtype)
    return u, bc[..., offset:offset + n], bc[..., offset + n:offset + 2 * n]


# (Bz, S, H, dh, N): zamba2-7b's prefill bucket, the 700-token prompt's
# bucket and one 4,096-token prompt
PATH = [(4, 256, 112, 64, 64), (1, 768, 112, 64, 64), (1, 4096, 112, 64, 64)]


@pytest.mark.parametrize("bz,s,h,dh,n", PATH)
def test_route_at_the_main_path_shapes(bz, s, h, dh, n):
    """A bf16 model's scan (u, B and C as the mixer hands them over)
    takes the tensor cores; the same shapes in f32 (phase 16's f32 rows,
    an f32 model) take the f32 FMA kernel."""
    assert kssd.ssd_route(*_operands(bz, s, h, dh, n, BF)) == "tensor_core"
    assert kssd.ssd_route(*_operands(bz, s, h, dh, n, F32)) == "fma"


def test_route_at_the_edges():
    """dh and N must be multiples of 16 (the sweep's dh 8, N 4 and zamba2
    smoke's N 8 take the FMA kernel); ragged S and a chunk longer than S
    do not matter (the rule does not see the chunk); B and C may be row
    views, but every row must start on 16 bytes; one operand in another
    dtype sends the call to the FMA kernel."""
    route = kssd.ssd_route
    assert route(*_operands(2, 32, 4, 8, 4, BF)) == "fma"
    assert route(*_operands(3, 13, 4, 16, 8, BF)) == "fma"
    assert route(*_operands(2, 100, 3, 48, 32, BF)) == "tensor_core"
    assert route(*_operands(1, 37, 2, 16, 16, BF)) == "tensor_core"
    assert route(*_operands(1, 1, 2, 64, 64, BF)) == "tensor_core"
    # contiguous B and C, and B, C views of a wider (bcdt-like) tensor
    u, b, c = _operands(2, 64, 2, 32, 16, BF)
    assert route(u, b.contiguous(), c.contiguous()) == "tensor_core"
    assert route(*_operands(2, 64, 2, 32, 16, BF, bc_width=48)) \
        == "tensor_core"
    # rows that do not start on 16 bytes: an odd row stride, a shifted base
    assert route(*_operands(2, 64, 2, 32, 16, BF, bc_width=36)) == "fma"
    assert route(*_operands(2, 64, 2, 32, 16, BF, offset=4)) == "fma"
    u, b, c = _operands(2, 64, 2, 32, 16, BF)
    assert route(u, b.float(), c) == "fma"
    assert route(u.float(), b, c) == "fma"
    shifted = torch.empty(2 * 64 * 2 * 32 + 8, dtype=BF)[8:].view(2, 64, 2, 32)
    assert route(shifted, b, c) == "tensor_core"
    shifted = torch.empty(2 * 64 * 2 * 32 + 4, dtype=BF)[4:].view(2, 64, 2, 32)
    assert route(shifted, b, c) == "fma"
    # a head stride that is not a multiple of 8 elements
    wide = torch.empty(2, 64, 2, 36, dtype=BF)[..., :32]
    assert route(wide, b, c) == "fma"


def test_tensor_core_shared_memory_fits_every_chunk_the_path_uses():
    """``tc_smem_bytes`` mirrors the source's formula (checked against
    the library on the card in ``tests/test_torch_cuda.py``): cum and dt
    over the chunk padded to 64 steps, and 64-row bf16 tiles of 72."""
    tile, ring = 64 * 72 * 2, kssd.STAGES
    assert kssd.tc_smem_bytes("chunk", 256) == 8 * 256 + 2 * ring * tile
    assert kssd.tc_smem_bytes("out", 256) == \
        8 * 256 + (ring + 1 + kssd.PIECES) * tile
    assert kssd.tc_smem_bytes("out", 37) == \
        8 * 64 + (ring + 1 + kssd.PIECES) * tile
    for q in (8, 37, 256, 1024):
        assert max(kssd.tc_smem_bytes(k, q) for k in ("chunk", "out")) \
            <= SMEM_LIMIT


# ---------------------------------------------------------------------------
# the tensor-core route, emulated
# ---------------------------------------------------------------------------

def _pieces(v: torch.Tensor, n: int) -> torch.Tensor:
    """The f32 value n bf16 pieces of v sum to (exact in f32, n <= 3)."""
    return ref.split_pieces(v, n).float().sum(0)


def emulate_ssd(u, dt, A, B, C, chunk: int, pieces: int = kssd.PIECES):
    """(y, final state) of the tensor-core route, in the kernel's order."""
    u, dt, A, B, C = (t.float() for t in (u, dt, A, B, C))
    bz, s, h, dh = u.shape
    n = B.shape[-1]
    q = min(chunk, s)
    nc = math.ceil(s / q)
    spans = [(c * q, min(q, s - c * q)) for c in range(nc)]
    a2 = A * LOG2E
    # launch 1: C B^T per (batch, chunk), and each head's S_c, cum, dt
    cb, cum, sc = [], [], []
    for c0, ql in spans:
        uc, bc, cc = u[:, c0:c0 + ql], B[:, c0:c0 + ql], C[:, c0:c0 + ql]
        cb.append(cc @ bc.mT)                                   # (bz,i,j)
        cm = torch.cumsum(dt[:, c0:c0 + ql] * a2, 1)            # (bz,j,h)
        cum.append(cm)
        w = dt[:, c0:c0 + ql] * torch.exp2(cm[:, -1:] - cm)
        wu = _pieces(w[..., None] * uc, pieces)                 # (bz,j,h,d)
        sc.append(torch.einsum("bjhd,bjn->bhdn", wu, bc))
    # launch 2: the state pass; each chunk's incoming state as pieces
    state = torch.zeros(bz, h, dh, n)
    s_prev = []
    for c in range(nc):
        s_prev.append(_pieces(state, pieces))
        state = torch.exp2(cum[c][:, -1])[..., None, None] * state + sc[c]
    # launch 3: the outputs
    ys = []
    for c, (c0, ql) in enumerate(spans):
        cm = cum[c]
        tri = torch.tril(torch.ones(ql, ql, dtype=torch.bool))[None, ..., None]
        li = torch.where(tri, cm[:, :, None] - cm[:, None], 0.0)
        g = torch.where(tri, cb[c][..., None] * torch.exp2(li)
                        * dt[:, c0:c0 + ql][:, None], 0.0)      # (bz,i,j,h)
        y = torch.einsum("bijh,bjhd->bihd", _pieces(g, pieces),
                         u[:, c0:c0 + ql])
        if c > 0:
            inter = torch.einsum("bin,bhdn->bihd", C[:, c0:c0 + ql],
                                 s_prev[c])
            y = torch.exp2(cm)[..., None] * inter + y
        ys.append(y)
    return torch.cat(ys, 1), state


def _inputs(bz, s, h, dh, n, seed, valid=None):
    """numpy inputs as tests/test_torch_mamba.py makes them, u, B and C
    rounded to bf16 (what the route reads), dt = 0 past ``valid``."""
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((bz, s, h, dh)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((bz, s, h)))).astype(np.float32)
    a = -np.exp(rng.standard_normal(h)).astype(np.float32)
    b = rng.standard_normal((bz, s, n)).astype(np.float32)
    c = rng.standard_normal((bz, s, n)).astype(np.float32)
    if valid is not None:
        live = np.arange(s)[None, :] < np.asarray(valid)[:, None]
        dt = np.where(live[..., None], dt, 0.0).astype(np.float32)
    u, b, c = (torch.from_numpy(t).to(BF).float().numpy() for t in (u, b, c))
    return u, dt, a, b, c


def _scaled_err(got, want) -> float:
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max()
                 / max(1.0, np.abs(want).max()))


# (Bz, S, H, dh, N, chunk, valid lengths): several chunks, a ragged last
# chunk, one chunk shorter than a tile, dt = 0 past each row's valid
# length, zamba2's chunk of 256 (dh = N = 64, 2 heads) with a second,
# ragged chunk
EMULATED = [(2, 64, 3, 16, 16, 16, None), (2, 100, 3, 32, 16, 32, None),
            (1, 37, 2, 16, 32, 37, None), (3, 96, 2, 16, 16, 32, (96, 20, 61)),
            (1, 320, 2, 64, 64, 256, None)]


@pytest.mark.parametrize("bz,s,h,dh,n,chunk,valid", EMULATED)
def test_emulated_route_matches_plain_and_reference(bz, s, h, dh, n, chunk,
                                                    valid):
    """y and the final state of the emulated route against the plain
    version and ``_ssd_chunked``, y against ``ssd_scan_tiled`` where S is
    a chunk multiple (it pads nothing); FINE at the reference's chunks,
    SSD_TOL at 256 (module docstring)."""
    args = _inputs(bz, s, h, dh, n, s + dh, valid)
    targs = [torch.from_numpy(t) for t in args]
    got_y, got_s = emulate_ssd(*targs, chunk)
    assert got_y.shape == (bz, s, h, dh) and got_s.shape == (bz, h, dh, n)
    tol = FINE if chunk <= 37 else SSD_TOL
    want_y, want_s = ref.ssd_scan_ref(*targs, chunk)
    assert _scaled_err(got_y, want_y) <= tol
    assert _scaled_err(got_s, want_s) <= tol
    ja = [jnp.asarray(t) for t in args]
    jy, js = rmamba._ssd_chunked(*ja, jnp.zeros((h,)), chunk,
                                 return_final=True)
    assert _scaled_err(got_y, jy) <= tol
    assert _scaled_err(got_s, js) <= tol
    if s % chunk == 0:
        assert _scaled_err(got_y, ssd_scan_tiled(*ja, chunk=chunk)) <= tol


def test_route_needs_two_pieces():
    """Why 2 pieces: they sum to each f32 operand within 2^-17 of its
    magnitude, which keeps every emulated shape within SSD_TOL / 4 of the
    plain version; 1 piece (bf16 rounding, 2^-9) misses SSD_TOL at every
    one. So the route runs 2, not the 3 that would be exact."""
    assert kssd.PIECES == 2
    for bz, s, h, dh, n, chunk, valid in EMULATED:
        targs = [torch.from_numpy(t)
                 for t in _inputs(bz, s, h, dh, n, s + dh, valid)]
        want = ref.ssd_scan_ref(*targs, chunk)
        for pieces, ok in ((kssd.PIECES, True), (kssd.PIECES - 1, False)):
            got = emulate_ssd(*targs, chunk, pieces=pieces)
            err = max(_scaled_err(g, w) for g, w in zip(got, want))
            assert (err <= SSD_TOL / 4) if ok else (err > SSD_TOL), \
                (bz, s, chunk, pieces, err)


# ---------------------------------------------------------------------------
# the mixer feeds the scan in its own dtype
# ---------------------------------------------------------------------------

def test_bf16_mixer_feeds_the_scan_as_stored_with_the_same_bits(
        monkeypatch):
    """zamba2 smoke's Mamba-2 mixer in bf16 hands the scan u, B and C in
    bf16 (B and C as views of one tensor); on the CPU its outputs, final
    state and gradients are bit for bit those of the mixer that cast u, B
    and C to f32 itself before the scan."""
    cfg = tconfigs.get_smoke("zamba2-7b")
    p = tmamba.init_mamba2(cfg, generator=torch.Generator().manual_seed(5),
                           dtype=BF)
    for t in p.parameters():
        t.requires_grad_(True)
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((2, 13, cfg.d_model))
                         .astype(np.float32)).to(BF)
    seen = []
    scan = ops.ssd_scan

    def spy(u, dt, A, B, C, D, chunk, **kw):
        seen.append((u.dtype, B.dtype, C.dtype, B.is_contiguous()))
        return scan(u, dt, A, B, C, D, chunk, **kw)

    def casting(u, dt, A, B, C, D, chunk, **kw):  # the mixer before
        return scan(u.float(), dt, A, B.float(), C.float(), D, chunk, **kw)

    def run(fn):
        monkeypatch.setattr(ops, "ssd_scan", fn)
        for t in p.parameters():
            t.grad = None
        vl = torch.tensor([13, 6])
        st = tmamba.init_mamba2_cache(cfg, 2, dtype=BF, device="cpu")
        y_pre, st, _ = tmamba.apply_mamba2(p, x, cfg, state=st, valid_len=vl)
        y, _, _ = tmamba.apply_mamba2(p, x, cfg)
        y.float().square().sum().backward()
        grads = [t.grad.clone() for t in p.parameters()]
        return [y_pre, st.ssm, y] + grads

    new = run(spy)
    assert seen and all(s == (BF, BF, BF, False) for s in seen)
    old = run(casting)
    assert len(new) == len(old)
    for a, b in zip(new, old):
        assert a.dtype == b.dtype and torch.equal(a, b)
