"""The bf16 tensor-core route of kernels #2 and #3, checked on the CPU.

On bf16 inputs the sketch forward and the backward compute every product
with an f32 operand (h, dh) as an f32 sum of exact bf16 x bf16 products
over bf16 pieces of that operand (``csrc/gemm_bf16.cuh``). Here a plain
emulation of that arithmetic (the pieces of ``ref.split_pieces``,
concatenated along the reduction, one f32 matmul) is held against the
plain versions at the main path's shapes, with ``chip_smoke.held``'s
tolerances, and against the reference's Pallas kernels in interpret mode at
small shapes. The split itself, the tile and split plans and the dispatch
rule are checked too. The card runs the kernels themselves
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 6).

Tolerances (``chip_smoke.held``): f32 sums of n terms in another order, 2 n
eps max(scale, 1); a bf16 output adds one rounding, 2^-7 of the scale.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import lowrank as rlowrank
from repro_torch.kernels import lowrank as tlowrank
from repro_torch.kernels import ref as tref

torch.set_num_threads(1)
EPS32 = float(np.finfo(np.float32).eps)
BF16 = torch.bfloat16

# qwen2-0.5b's four training site shapes (I, K, O)
SITES = {"attn/wq|wo": (896, 256, 896), "attn/wk|wv": (896, 128, 128),
         "mlp/gate|up": (896, 256, 4864), "mlp/down": (4864, 256, 896)}
P_OUT16, P_OUT32 = tlowrank.PIECES_BF16_OUT, tlowrank.PIECES_F32_OUT


def _tol(n, want, bf16_out=False):
    scale = float(want.abs().max())
    tol = 2 * n * EPS32 * max(scale, 1.0)
    return tol + (2.0 ** -7 * scale if bf16_out else 0.0)


def _err(got, want):
    return float((got.float() - want.float()).abs().max())


def _inputs(m, i, k, o, seed):
    """bf16 x, R, L, dy from seeded numpy draws (R, L scaled as the
    plan's factors), and the f32 sketch h = x R^T."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((m, i), np.float32)).to(BF16)
    r = torch.from_numpy((rng.standard_normal((k, i)) * i ** -0.5)
                         .astype(np.float32)).to(BF16)
    l_ = torch.from_numpy((rng.standard_normal((o, k)) * k ** -0.5)
                          .astype(np.float32)).to(BF16)
    dy = torch.from_numpy(rng.standard_normal((m, o), np.float32)).to(BF16)
    return x, r, l_, dy, x.float() @ r.float().T


def _pieced(lefts, rights):
    """sum_p lefts[p] @ rights[p] as ONE f32 matmul over the reduction
    concatenated across pieces: what one accumulator of the kernel sums."""
    return (torch.cat([a.float() for a in lefts], dim=1)
            @ torch.cat([b.float() for b in rights], dim=0))


def emulate_sketch(x, r, l_):
    """(y before its bf16 rounding, h) of the bf16 sketch kernel."""
    h = x.float() @ r.float().T
    hp = tref.split_pieces(h, P_OUT16)
    return _pieced(list(hp), [l_.T] * P_OUT16), h


def emulate_bwd(dy, x, h, l_, r):
    """(dx before its bf16 rounding, dL, dR) of the bf16 backward."""
    dh = dy.float() @ l_.float()
    dhp = tref.split_pieces(dh, P_OUT32)
    hp = tref.split_pieces(h, P_OUT32)
    dx = _pieced(list(dhp[:P_OUT16]), [r] * P_OUT16)
    dl = _pieced([dy.T] * P_OUT32, list(hp))
    dr = _pieced([p.T for p in dhp], [x] * P_OUT32)
    return dx, dl, dr


# ---------------------------------------------------------------------------
# the split
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_split_pieces_sum_to_the_value(seed):
    """hi + mid + lo == v exactly, hi + lo within 2^-17 |v|, on f32 draws
    whose exponents span 2^-100 to 2^100 (lo stays above bf16's smallest
    normal, so nothing underflows), zeros and both signs included."""
    rng = np.random.default_rng(seed)
    n = 200_000
    v = (rng.uniform(1, 2, n) * 2.0 ** rng.integers(-100, 101, n)
         * rng.choice([-1.0, 1.0], n)).astype(np.float32)
    v[:7] = [0.0, -0.0, 1.0, -1.0, 3.0e38, 1.5e-30, 2.0 ** -100]
    vt = torch.from_numpy(v)
    p3 = tref.split_pieces(vt, 3)
    assert p3.dtype == BF16 and p3.shape == (3, n)
    exact = p3.double().sum(0)
    assert torch.equal(exact, vt.double())
    p2 = tref.split_pieces(vt, 2)
    assert torch.equal(p2, p3[:2])             # the same first pieces
    err = (p2.double().sum(0) - vt.double()).abs()
    assert bool((err <= 2.0 ** -17 * vt.double().abs()).all())
    # a piece is the bf16 rounding of what the earlier ones left
    assert torch.equal(p3[0], vt.to(BF16))


# ---------------------------------------------------------------------------
# the emulated arithmetic against the plain versions (the phase-6 gate)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", [2048, 1000])
@pytest.mark.parametrize("site", list(SITES))
def test_pieced_products_meet_the_plain_versions_tolerances(site, m):
    """At every main-path shape the chosen pieces leave the f32 sums
    within a quarter of the f32 part of the tolerance (the 4x margin), and
    the outputs, rounded as the kernels store them, within the whole
    tolerance. dL and dR take three pieces and so exact products; y and dx
    take two, whose error (2^-17 of each term) the bf16 output's rounding
    dwarfs."""
    i, k, o = SITES[site]
    x, r, l_, dy, h = _inputs(m, i, k, o, seed=m + i + k + o)
    y32, h_got = emulate_sketch(x, r, l_)
    want_y, want_h = tref.lowrank_sketch_ref(x, r, l_, out_dtype=torch.float32)
    assert torch.equal(h_got, want_h)          # one piece: the same products
    assert _err(y32, want_y) <= _tol(i + k, want_y) / 4
    assert _err(y32.to(BF16), want_y) <= _tol(i + k, want_y, bf16_out=True)

    got = emulate_bwd(dy, x, h, l_, r)
    want = tref.lowrank_bwd_ref(dy, x.float(), h, l_, r)   # dx in f32
    for g, w, n in zip(got, want, (o + k, m, o + m)):
        assert _err(g, w) <= _tol(n, w) / 4, (n, _err(g, w), _tol(n, w))
    assert _err(got[0].to(BF16), want[0]) <= _tol(o + k, want[0], True)


@pytest.mark.parametrize("m,i,k,o", [(64, 96, 24, 48), (40, 128, 16, 64),
                                     (17, 64, 8, 32)])
def test_pieced_products_match_the_pallas_kernels_in_interpret_mode(m, i, k,
                                                                     o):
    """The emulation against ``lowrank_fused_tiled(save_sketch=True)`` and
    ``lowrank_bwd_tiled`` on the same bf16 inputs: y (bf16) sums I then K
    terms, h I, dx (bf16) O then K, dL M, dR O then M."""
    x, r, l_, dy, _ = _inputs(m, i, k, o, seed=11)

    def j(t):
        return jnp.asarray(t.float().numpy(), dtype=jnp.bfloat16)

    wy, wh = rlowrank.lowrank_fused_tiled(j(x), j(r).T, j(l_).T,
                                          save_sketch=True, interpret=True)
    y32, h = emulate_sketch(x, r, l_)
    wh = torch.from_numpy(np.array(wh))
    wy = torch.from_numpy(np.array(wy, np.float32))
    assert _err(h, wh) <= _tol(i, wh)
    assert _err(y32.to(BF16), wy) <= _tol(i + k, wy, bf16_out=True)

    want = rlowrank.lowrank_bwd_tiled(j(dy), j(x), jnp.asarray(h.numpy()),
                                      j(l_), j(r), interpret=True)
    want = [torch.from_numpy(np.array(w, np.float32)) for w in want]
    got = emulate_bwd(dy, x, h, l_, r)
    assert _err(got[0].to(BF16), want[0]) <= _tol(o + k, want[0], True)
    assert _err(got[1], want[1]) <= _tol(m, want[1])
    assert _err(got[2], want[2]) <= _tol(o + m, want[2])


# ---------------------------------------------------------------------------
# plans and the dispatch rule
# ---------------------------------------------------------------------------

def _ranges(steps, splits):
    """The kernel's split rule: range s covers [s T / S, (s + 1) T / S)."""
    return [(s * steps // splits, (s + 1) * steps // splits)
            for s in range(splits)]


PLAN_SHAPES = [(2048,) + SITES[s] for s in SITES] \
    + [(1000,) + SITES[s] for s in SITES] \
    + [(1, 896, 256, 896), (37, 64, 8, 32), (3, 4864, 256, 8)]


@pytest.mark.parametrize("m,i,k,o", PLAN_SHAPES)
def test_tensor_core_plans_cover_each_product_and_size_the_workspace(m, i, k,
                                                                     o):
    """Each product's tiles cover its output, its split ranges cover every
    step of the pieced reduction once, in order, each >= MIN_SPLIT_STEPS
    steps (or one range); 128-wide tiles where >= 96 of them fill the card
    unsplit or a split brings them to 128-264 blocks (~1-2 an SM), 64-wide
    tiles split to at most ~1 block an SM; the workspace holds every split
    product's partials."""
    sp, bp = tlowrank.sketch_plan(m, i, k, o), tlowrank.bwd_plan(m, i, k, o)
    prods = [(sp.h, sp.ws, m, k, i, 1), (sp.y, sp.ws, m, o, k, P_OUT16),
             (bp.dh, bp.ws, m, k, o, 1), (bp.dx, bp.ws, m, i, k, P_OUT16),
             (bp.dl, bp.ws, o, k, m, P_OUT32),
             (bp.dr, bp.ws, k, i, m, P_OUT32)]
    for plan, ws, rows, cols, red, pieces in prods:
        t = plan.tile
        assert t in (64, 128)
        assert -(-rows // t) * t >= rows and -(-cols // t) * t >= cols
        tiles = -(-rows // t) * -(-cols // t)
        if t == 128:
            assert (tiles >= 96 and plan.splits == 1) or \
                128 <= tiles * plan.splits <= 2 * tlowrank.SMS
        else:
            assert tiles * plan.splits <= max(tiles, tlowrank.SMS)
        steps = pieces * -(-red // tlowrank.STEP)
        rs = _ranges(steps, plan.splits)
        assert rs[0][0] == 0 and rs[-1][1] == steps
        assert all(a[1] == b[0] for a, b in zip(rs, rs[1:]))
        assert plan.splits == 1 or all(
            b - a >= tlowrank.MIN_SPLIT_STEPS for a, b in rs)
        if plan.splits > 1:
            assert ws >= plan.splits * rows * cols


def test_tensor_core_route_rule():
    """bf16 with widths that are multiples of 8 and 16-byte aligned bases
    take the tensor-core kernels; f32, odd widths (the ragged rows of
    tests/test_torch_cuda.py's BWD_SHAPES) and misaligned views take the
    f32 FMA kernels."""
    route = tlowrank.tensor_core_route
    x = torch.zeros(8, 896, dtype=BF16)
    assert all(route(BF16, w, (x,)) for w in SITES.values())
    assert route(BF16, (96, 24, 48), (x,))
    assert not route(torch.float32, (896, 256, 896), (x.float(),))
    for w in [(70, 5, 33), (130, 100, 7), (96, 24, 44), (4, 8, 8)]:
        assert not route(BF16, w, (x,))
    flat = torch.zeros(8 * 896 + 8, dtype=BF16)
    shifted = flat[1:1 + 8 * 896].view(8, 896)    # base 2 bytes past 16
    assert shifted.data_ptr() % 16 == 2
    assert not route(BF16, (896, 256, 896), (x, shifted))
    assert route(BF16, (896, 256, 896), (x, flat[8:].view(8, 896)))


def piece_bounds(m: int) -> list[str]:
    """Per main-path shape at M = m: for y and dx (two pieces) the
    worst-case piece error 2^-17 max sum|terms| and the measured error of
    the emulation, each against the f32 part of the tolerance; for dL and
    dR (three pieces, exact products) the measured error."""
    lines = []
    for site, (i, k, o) in SITES.items():
        x, r, l_, dy, h = _inputs(m, i, k, o, seed=m + i + k + o)
        y32, _ = emulate_sketch(x, r, l_)
        wy, _ = tref.lowrank_sketch_ref(x, r, l_, out_dtype=torch.float32)
        got = emulate_bwd(dy, x, h, l_, r)
        want = tref.lowrank_bwd_ref(dy, x.float(), h, l_, r)
        dh = dy.float() @ l_.float()
        cells = []
        for name, g, w, n, terms in (
                ("y", y32, wy, i + k, h.abs() @ l_.float().abs().T),
                ("dx", got[0], want[0], o + k, dh.abs() @ r.float().abs()),
                ("dL", got[1], want[1], m, None),
                ("dR", got[2], want[2], o + m, None)):
            tol = _tol(n, w)
            err = _err(g, w)
            bound = (f"bound/tol {2.0 ** -17 * float(terms.max()) / tol:.3f} "
                     if terms is not None else "")
            cells.append(f"{name}: {bound}err {err:.2e} tol {tol:.2e} "
                         f"margin {tol / max(err, 1e-30):.0f}x")
        lines.append(f"M={m} {site:12s} " + " | ".join(cells))
    return lines


if __name__ == "__main__":
    # PYTHONPATH=src python tests/test_torch_split.py
    for m_rows in (2048, 1000):
        print("\n".join(piece_bounds(m_rows)), flush=True)
