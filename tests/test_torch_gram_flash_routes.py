"""The arithmetic of the redesigned kernels #5 (the Gram) and #7 (flash
attention), checked on the CPU.

Their CUDA kernels run only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py`` phases 6 and 13); here the route rules and plans are
pinned, and a plain emulation of what each new route sums, and in which
order, is held against the plain versions (``ref.py``) and against the
reference's Pallas kernels in interpret mode on the same numpy inputs:

* #5's tensor-core route (``csrc/gram.cu``'s ``gram_bf16`` on
  ``gemm_bf16.cuh`` with its TRI option): only the upper-triangle tiles
  (i <= j) of G, numbered as the kernel numbers them, each the f32 sum of
  exact bf16 products over ``gram_plan``'s split ranges of 64-row steps,
  the ranges summed in split order, each value stored at (i, j) and (j,
  i);
* #7's f32 route: q, k, v and p split into ``PIECES`` exact bf16 pieces
  (``ref.split_pieces``, the kernel's ``split_bf16`` rule), each product
  the sum of the pairs of pieces whose indices sum to < PIECES, an online
  softmax in exp2 with log2(e) folded into the f32 scale, over the plan's
  key tiles;
* #7's bf16 route: the same softmax, p rounded to bf16 before p . v.

Each tile partial is one f32 matmul here: the order of the card's sums
inside it is its own. Tolerances as ``chip_smoke.py`` states them: the
Gram's f32 sums of M terms in another order, 2 M eps max(scale, 1); flash
attention 2e-5 at unit-normal inputs in f32, 2 bf16 ulps of the output's
scale in bf16.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro.kernels.gram import gram_tiled
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import gram as tgram
from repro_torch.kernels import ref as tref
from repro_torch.kernels.lowrank import (
    MIN_SPLIT_STEPS,
    SMEM_LIMIT,
    SMS,
    STEP,
    GemmPlan,
)

torch.set_num_threads(1)
EPS32 = float(np.finfo(np.float32).eps)
BF16, F32 = torch.bfloat16, torch.float32
LOG2E = np.float32(1.4426950408889634)   # csrc/flash_attn.cu: LOG2E
ATOL_F32 = 2e-5

# qwen2-0.5b's stacked refresh operands (repeat, O, K), as phase 6 has them
STACKS = {"attn/wq|wo": (24, 896, 256), "attn/wk|wv": (24, 128, 128),
          "mlp/gate|up": (24, 4864, 256), "mlp/down": (24, 896, 256)}


# ---------------------------------------------------------------------------
# kernel #5: the Gram
# ---------------------------------------------------------------------------

def _aligned_bf16(*shape):
    return torch.zeros(shape, dtype=BF16)


def _misaligned_bf16(*shape):
    """A bf16 view whose base is 2 bytes past a 16-byte boundary."""
    flat = torch.zeros(math.prod(shape) + 8, dtype=BF16)
    off = (-flat.data_ptr() // 2) % 8 + 1
    return flat[off:off + math.prod(shape)].view(shape)


@pytest.mark.parametrize("dtype,k,make,want", [
    (BF16, 256, _aligned_bf16, "tensor_core"),
    (BF16, 128, _aligned_bf16, "tensor_core"),
    (BF16, 40, _aligned_bf16, "tensor_core"),
    (BF16, 8, _aligned_bf16, "tensor_core"),
    (BF16, 5, _aligned_bf16, "fma"),       # GRAM_SHAPES' ragged K
    (BF16, 12, _aligned_bf16, "fma"),
    (BF16, 256, _misaligned_bf16, "fma"),
    (F32, 256, lambda *s: torch.zeros(s), "fma"),
    (F32, 40, lambda *s: torch.zeros(s), "fma"),
])
def test_gram_route_rule(dtype, k, make, want):
    y = make(3, 100, k)
    assert y.dtype == dtype
    assert tgram.gram_route(dtype, k, (y,)) == want


# (b, m, k) -> (tile, splits): the main path's four stacks (three
# shapes), a single 2-D Y, GRAM_SHAPES' small stacks
@pytest.mark.parametrize("b,m,k,want", [
    (24, 4864, 256, (64, 1)),
    (24, 896, 256, (64, 1)),
    (24, 128, 128, (64, 1)),
    (1, 2048, 256, (64, 8)),
    (1, 4864, 256, (64, 13)),
    (2, 896, 256, (64, 3)),
    (3, 100, 40, (64, 1)),
    (2, 37, 8, (64, 1)),
    (64, 4864, 256, (64, 1)),
])
def test_gram_plan_pins(b, m, k, want):
    plan = tgram.gram_plan(b, m, k)
    assert tuple(plan) == want
    tile, s = plan
    steps = -(-m // STEP)
    # a split keeps >= MIN_SPLIT_STEPS steps, and the grid stays within
    # ~2 blocks an SM
    assert s == 1 or steps // s >= MIN_SPLIT_STEPS
    assert b * tgram.tri_tiles(k, tile) * s <= 2 * SMS or s == 1


def tri_tile(tiles, t):
    """gemm_bf16.cuh's tri_tile: upper-triangle tile t of a tiles x tiles
    grid, numbered row by row."""
    i = 0
    while t >= tiles - i:
        t -= tiles - i
        i += 1
    return i, i + t


@pytest.mark.parametrize("tiles", [1, 2, 3, 4, 7, 9])
def test_tri_tile_map_covers_the_upper_triangle_once(tiles):
    got = [tri_tile(tiles, t) for t in range(tgram.tri_tiles(tiles, 1))]
    assert got == [(i, j) for i in range(tiles) for j in range(i, tiles)]


def emulate_gram(y: torch.Tensor, plan: GemmPlan) -> torch.Tensor:
    """The tensor-core route's sums: per upper tile (i, j) and split range
    of 64-row steps, the f32 sum of the steps' exact bf16 products; the
    ranges summed in split order; the tile stored at (i, j) and (j, i), a
    diagonal tile's upper half mirrored."""
    b, m, k = y.shape
    tile, s = plan
    tiles, steps = -(-k // tile), -(-m // STEP)
    yf = y.float()
    g = torch.full((b, k, k), float("nan"))
    for t in range(tgram.tri_tiles(k, tile)):
        i, j = tri_tile(tiles, t)
        ri, rj = slice(i * tile, (i + 1) * tile), slice(j * tile, (j + 1) * tile)
        total = None
        for sp in range(s):
            acc = torch.zeros(b, yf[:, :, ri].shape[-1], yf[:, :, rj].shape[-1])
            for st in range(sp * steps // s, (sp + 1) * steps // s):
                rows = slice(st * STEP, (st + 1) * STEP)
                acc = acc + yf[:, rows, ri].mT @ yf[:, rows, rj]
            total = acc if total is None else total + acc
        if i == j:
            total = torch.triu(total) + torch.triu(total, 1).mT
        g[:, ri, rj] = total
        g[:, rj, ri] = total.mT
    return g


def _y(b, m, k, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, m, k)).astype(np.float32)


@pytest.mark.parametrize("b,m,k", [(3, 100, 40), (2, 300, 64), (1, 2048, 256),
                                   (24, 128, 128), (24, 896, 256),
                                   (24, 4864, 256)])
def test_gram_emulation_matches_plain_and_reference_kernel(b, m, k):
    y = torch.from_numpy(_y(b, m, k, m + k)).to(BF16)
    plan = tgram.gram_plan(b, m, k)
    got = emulate_gram(y, plan)
    assert torch.equal(got, got.mT)         # exactly symmetric
    want = tref.gram_ref(y)
    scale = float(want.abs().max())
    tol = 2 * m * EPS32 * max(scale, 1.0)
    assert float((got - want).abs().max()) <= tol
    # the reference's Pallas kernel (interpret mode) on the same bf16
    # inputs, at the first two stack indices
    for i in range(min(b, 2)):
        ref_g = np.asarray(gram_tiled(jnp.asarray(y[i].float().numpy())
                                      .astype(jnp.bfloat16)))
        assert float(np.abs(got[i].numpy() - ref_g).max()) <= tol


@pytest.mark.parametrize("plan", [(64, 2), (64, 3), (64, 1), (64, 4)])
def test_gram_emulation_is_symmetric_at_every_plan(plan):
    y = torch.from_numpy(_y(2, 700, 136, 5)).to(BF16)
    got = emulate_gram(y, GemmPlan(*plan))
    assert torch.equal(got, got.mT)
    want = tref.gram_ref(y)
    tol = 2 * 700 * EPS32 * max(float(want.abs().max()), 1.0)
    assert float((got - want).abs().max()) <= tol


# ---------------------------------------------------------------------------
# kernel #7: flash attention
# ---------------------------------------------------------------------------

# (b, sq, h, dh, dtype) -> (dp, bq, ks, stages, bk): the paths' shapes
# (ViT-B/16 at batch 64, f32; qwen2-0.5b training and a prefill bucket;
# zamba2-7b's 4 x 256 prefill bucket), then the edges: head dims 16-256, a
# long sequence, small grids, both sides of KS2_MAX_BLOCKS (qwen2 prefill
# buckets of 3 and 4 x 256: 168 and 224 blocks)
@pytest.mark.parametrize("b,s,h,dh,dtype,want", [
    (64, 197, 12, 64, F32, (64, 128, 1, 1, 64)),
    (4, 512, 14, 64, BF16, (64, 64, 1, 3, 64)),
    (2, 256, 14, 64, BF16, (64, 64, 2, 3, 64)),
    (4, 256, 32, 112, BF16, (128, 64, 1, 3, 64)),
    (4, 197, 12, 64, F32, (64, 128, 1, 1, 64)),
    (1, 512, 14, 64, BF16, (64, 64, 2, 3, 64)),
    (2, 1024, 14, 64, BF16, (64, 64, 1, 3, 64)),
    (1, 4096, 14, 64, BF16, (64, 64, 1, 3, 64)),
    (2, 100, 2, 16, F32, (32, 128, 1, 1, 64)),
    (2, 100, 2, 16, BF16, (32, 64, 2, 3, 64)),
    (1, 384, 2, 128, F32, (128, 64, 1, 1, 32)),
    (64, 384, 8, 128, F32, (128, 64, 1, 1, 32)),
    (1, 80, 2, 256, F32, (256, 64, 1, 1, 16)),
    (1, 80, 2, 256, BF16, (256, 64, 1, 2, 64)),
    (1, 1, 1, 8, BF16, (32, 64, 2, 3, 64)),
    (3, 256, 14, 64, BF16, (64, 64, 2, 3, 64)),
    (4, 256, 14, 64, BF16, (64, 64, 1, 3, 64)),
    (8, 17, 4, 16, F32, (32, 128, 1, 1, 64)),
    (16, 197, 12, 64, F32, (64, 128, 1, 1, 64)),
])
def test_flash_plan_pins(b, s, h, dh, dtype, want):
    plan = tflash.flash_plan(b, s, s, h, dh, dtype)
    assert tuple(plan) == want
    assert plan in tflash.plans(dh, dtype)


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("dh", [8, 16, 24, 40, 64, 96, 112, 128, 256])
def test_flash_plans_fit_shared_memory(dh, dtype):
    """Every instantiated plan fits one block's shared memory, and the
    staging rules hold: q's pieces fit where they are staged."""
    for plan in tflash.plans(dh, dtype):
        assert plan.dp >= dh and plan.dp % 16 == 0
        smem = tflash.flash_smem_bytes(plan.dp, dtype, plan.bq, plan.stages,
                                       plan.ks)
        assert 0 < smem <= SMEM_LIMIT
        if tflash.q_in_registers(plan.dp, dtype):
            assert plan.bq <= 2 * plan.bk      # q stages in a K/V region
        assert plan.bk % 16 == 0
        # two key groups merge 4 + dp / 2 floats a lane through the ring
        if plan.ks == 2:
            assert (plan.bq // 16) * 32 * (4 + plan.dp // 2) * 4 <= smem


def emulate_flash(q, k, v, *, causal, window, plan, pieces=None):
    """The kernel's sums at ``plan``'s key tiles: scores from the kept
    pairs of pieces of q and k (f32; bf16: one piece, as stored), scaled
    by f32(f32(dh^-0.5) log2(e)), masked, an online softmax in exp2; p .
    v from the kept pairs of pieces of p and v (bf16: p rounded to bf16);
    with ``plan.ks`` key groups, tile t in group t % ks, the groups'
    (m, l, o) merged at the end; o / max(l, 1e-30). q (B, Sq, H, dh), k
    and v (B, Sk, KVH, dh)."""
    b, sq, h, dh = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    f32 = q.dtype == F32
    n = (pieces or tflash.PIECES) if f32 else 1
    grp = h // kvh
    qf = q.float().permute(0, 2, 1, 3)
    kf = k.float().permute(0, 2, 1, 3).repeat_interleave(grp, 1)
    vf = v.float().permute(0, 2, 1, 3).repeat_interleave(grp, 1)
    scale = torch.tensor(np.float32(np.float32(dh ** -0.5) * LOG2E))

    def kept(a, c, fn):
        # pairs (i, j), i + j < n, the smaller terms first
        total = None
        for s_ in range(n - 1, -1, -1):
            for i in range(s_ + 1):
                t = fn(a[i], c[s_ - i])
                total = t if total is None else total + t
        return total

    qp = tref.split_pieces(qf, n).float()
    states = [(torch.full((b, h, sq), -1e30), torch.zeros(b, h, sq),
               torch.zeros(b, h, sq, dh)) for _ in range(plan.ks)]
    qpos = torch.arange(sq)[:, None]
    for k0 in range(0, sk, plan.bk):
        g = (k0 // plan.bk) % plan.ks
        m, l_, o = states[g]
        kp = tref.split_pieces(kf[:, :, k0:k0 + plan.bk], n).float()
        vp = tref.split_pieces(vf[:, :, k0:k0 + plan.bk], n).float()
        s = kept(qp, kp, lambda a, c: a @ c.mT) * scale
        kpos = torch.arange(k0, min(k0 + plan.bk, sk))[None, :]
        ok = kpos < sk
        if causal:
            ok = ok & (kpos <= qpos)
        if window > 0:
            ok = ok & (kpos > qpos - window)
        s = torch.where(ok, s, torch.tensor(-1e30))
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new[..., None])
        l_ = l_ * alpha + p.sum(-1)
        pp = tref.split_pieces(p, n).float()
        o = o * alpha[..., None] + kept(pp, vp, lambda a, c: a @ c)
        states[g] = (m_new, l_, o)
    m, l_, o = states[0]
    for m1, l1, o1 in states[1:]:
        m_new = torch.maximum(m, m1)
        a0, a1 = torch.exp2(m - m_new), torch.exp2(m1 - m_new)
        l_ = l_ * a0 + l1 * a1
        o = o * a0[..., None] + o1 * a1[..., None]
        m = m_new
    out = o / torch.clamp(l_, min=1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)


def _qkv(b, s, h, kvh, dh, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, s, n, dh)).astype(np.float32)
                 for n in (h, kvh, kvh))


def _bf16_tol(want):
    scale = float(want.float().abs().max())
    return 2 * 2.0 ** (math.floor(math.log2(scale)) - 7)


# (B, S, H, KVH, dh, causal, window): the reference's sweep (chip_smoke's
# FLASH_SWEEP), the vit-smoke attention (phase 14) and a ViT-B/16-shaped
# one at batch 2
FLASH_SHAPES = [(2, 128, 4, 2, 32, True, 0), (1, 256, 4, 4, 64, True, 64),
                (2, 100, 2, 1, 16, False, 0), (1, 384, 2, 2, 128, True, 128),
                (1, 64, 8, 2, 96, True, 0), (8, 17, 4, 4, 16, False, 0),
                (2, 197, 12, 12, 64, False, 0)]


@pytest.mark.parametrize("b,s,h,kvh,dh,causal,window", FLASH_SHAPES)
def test_flash_f32_pieces_match_plain_and_reference_kernel(b, s, h, kvh, dh,
                                                           causal, window):
    """The f32 route over 3 exact bf16 pieces and 6 pairs per product, at
    the plan's tiles, within 2e-5 of the plain version and of the
    reference's Pallas kernel (interpret mode)."""
    q, k, v = _qkv(b, s, h, kvh, dh, s + dh)
    tq, tk, tv = (torch.from_numpy(t) for t in (q, k, v))
    plan = tflash.flash_plan(b, s, s, h, dh, F32)
    got = emulate_flash(tq, tk, tv, causal=causal, window=window, plan=plan)
    want = tref.flash_attention_ref(tq, tk, tv, causal=causal, window=window)
    assert float((got - want).abs().max()) <= ATOL_F32
    ref_o = np.asarray(rops.flash_attention(
        *(jnp.asarray(t) for t in (q, k, v)), causal=causal, window=window))
    assert float(np.abs(got.numpy() - ref_o).max()) <= ATOL_F32


def test_flash_f32_needs_three_pieces():
    """Why 3 pieces: at qwen2-0.5b's training heads (14/2, dh 64, causal,
    512 tokens) in f32, 2 pieces (3 pairs) miss the 2e-5 tolerance (the
    dropped pairs are ~2^-16 of each product), 3 pieces (6 pairs) keep it
    with a wide margin (the dropped pairs are ~2^-24)."""
    q, k, v = (torch.from_numpy(t) for t in _qkv(4, 512, 14, 2, 64, 576))
    plan = tflash.flash_plan(4, 512, 512, 14, 64, F32)
    want = tref.flash_attention_ref(q, k, v, causal=True)
    err = {n: float((emulate_flash(q, k, v, causal=True, window=0, plan=plan,
                                   pieces=n) - want).abs().max())
           for n in (2, 3)}
    assert tflash.PIECES == 3
    assert err[2] > ATOL_F32
    assert err[3] <= ATOL_F32 / 4


# the bf16 paths' shapes at smoke batch and heads: qwen2 (GQA 14/2, dh 64),
# zamba2's shared attention (dh 112), a window, a ragged bucket
BF16_SHAPES = [(1, 256, 14, 2, 64, True, 0), (1, 256, 4, 4, 112, True, 0),
               (2, 150, 4, 2, 40, False, 33), (2, 100, 2, 1, 16, False, 0),
               (1, 80, 2, 2, 256, True, 0)]


@pytest.mark.parametrize("b,s,h,kvh,dh,causal,window", BF16_SHAPES)
def test_flash_bf16_route_matches_plain_and_reference_kernel(b, s, h, kvh,
                                                             dh, causal,
                                                             window):
    """The bf16 route (p rounded to bf16 before p . v, the normaliser
    unrounded) within 2 bf16 ulps of the output's scale of the plain
    version and of the reference's Pallas kernel (interpret mode) on the
    same bf16 inputs."""
    q, k, v = _qkv(b, s, h, kvh, dh, s + dh + 1)
    tq, tk, tv = (torch.from_numpy(t).to(BF16) for t in (q, k, v))
    plan = tflash.flash_plan(b, s, s, h, dh, BF16)
    got = emulate_flash(tq, tk, tv, causal=causal, window=window, plan=plan)
    assert got.dtype == BF16
    want = tref.flash_attention_ref(tq, tk, tv, causal=causal, window=window)
    tol = _bf16_tol(want)
    assert float((got.float() - want.float()).abs().max()) <= tol
    jq, jk, jv = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                  for t in (tq, tk, tv))
    ref_o = np.asarray(rops.flash_attention(jq, jk, jv, causal=causal,
                                            window=window).astype(jnp.float32))
    assert float(np.abs(got.float().numpy() - ref_o).max()) <= tol
