"""The training kernels' plain versions, and the modules around them,
against the reference on the same numpy inputs.

On the CPU every dispatch in ``repro_torch.kernels.ops`` takes its plain
version; here each is held against the reference's Pallas kernel in
interpret mode (or its jnp version where the reference's own dispatch takes
that), and the modules of the training slice (CholeskyQR, the WSI refresh,
the loss, the optimizers) against theirs. The CUDA kernels are held against
the same plain versions on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).

Tolerances: f32 sums of n terms taken in another order differ by at most
n eps times the scale of the terms; each test names its n. Reductions of
the Pallas kernels in interpret mode pad K, I and O to lane multiples of
128, which adds zeros only.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import TrainConfig as RTrainConfig
from repro.core import orthogonal as rorth
from repro.core import wsi as rwsi
from repro.kernels import lowrank as rlowrank
from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro.nn.losses import masked_xent as rxent
from repro.optim import clip_by_global_norm as rclip
from repro.optim import cosine_schedule as rcosine
from repro.optim import init_optimizer as rinit_opt
from repro.optim import optimizer_update as rupdate
from repro_torch.config import TrainConfig
from repro_torch.core import orthogonal as torth
from repro_torch.core import wsi as twsi
from repro_torch.kernels import gram as tgram
from repro_torch.kernels import lowrank as tlowrank
from repro_torch.kernels import ops as tops
from repro_torch.kernels import qr as tqr
from repro_torch.kernels import ref as tref
from repro_torch.nn.losses import masked_xent as txent
from repro_torch.optim import clip_by_global_norm as tclip
from repro_torch.optim import cosine_schedule as tcosine
from repro_torch.optim import init_optimizer as tinit_opt
from repro_torch.optim import optimizer_update as tupdate

torch.set_num_threads(1)
EPS32 = float(np.finfo(np.float32).eps)

# (M, I, K, O): ragged, and the attn/wq and mlp/down site shapes of
# qwen2-0.5b at a small row count
SHAPES = [(32, 96, 24, 48), (17, 70, 5, 33), (9, 130, 100, 7),
          (8, 896, 256, 896), (8, 4864, 256, 896)]


def _tol(n, scale):
    return 2 * n * EPS32 * max(float(scale), 1.0)


def _close(got, want, n):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=_tol(n, np.abs(want).max()))


def _lowrank_inputs(m, i, k, o, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, i)).astype(np.float32)
    r = (rng.standard_normal((k, i)) * i ** -0.5).astype(np.float32)
    l_ = (rng.standard_normal((o, k)) * k ** -0.5).astype(np.float32)
    dy = rng.standard_normal((m, o)).astype(np.float32)
    return x, r, l_, dy


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _graph_nodes(t: torch.Tensor) -> set:
    """Names of the autograd nodes behind ``t``."""
    seen, todo = set(), [t.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or type(fn).__name__ in seen:
            continue
        seen.add(type(fn).__name__)
        todo.extend(f for f, _ in fn.next_functions)
    return seen


# ---------------------------------------------------------------------------
# kernels #2 and #3: the sketch forward and the fused backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,i,k,o", SHAPES)
def test_sketch_plain_version_matches_pallas_sketch_kernel(m, i, k, o):
    """y sums I then K terms, h I terms."""
    x, r, l_, _ = _lowrank_inputs(m, i, k, o)
    y, h = tref.lowrank_sketch_ref(*_t(x, r, l_))
    wy, wh = rlowrank.lowrank_fused_tiled(
        jnp.asarray(x), jnp.asarray(r).T, jnp.asarray(l_).T,
        save_sketch=True, interpret=True)
    assert h.dtype == torch.float32 and wh.dtype == jnp.float32
    _close(h.numpy(), wh, i)
    _close(y.numpy(), wy, i + k)


@pytest.mark.parametrize("m,i,k,o", SHAPES)
def test_bwd_plain_version_matches_pallas_bwd_kernel(m, i, k, o):
    """dx sums O then K terms, dL M terms, dR O then M terms. (The
    reference's own test of this kernel holds it to 1e-5 and fails by f32
    reassociation alone; see ROADMAP.md queue 3.)"""
    x, r, l_, dy = _lowrank_inputs(m, i, k, o, seed=1)
    h = x @ r.T
    got = tops.lowrank_bwd_fused(*_t(dy, x, h, l_, r))
    want = rops.lowrank_bwd_fused(*(jnp.asarray(a) for a in (dy, x, h, l_, r)))
    assert [g.dtype for g in got] == [torch.float32] * 3
    for g, w, n in zip(got, want, (o + k, m, o + m)):
        _close(g.numpy(), w, n)


@pytest.mark.parametrize("m,i,k,o", SHAPES[:3])
def test_bwd_plain_version_matches_reference_oracle(m, i, k, o):
    x, r, l_, dy = _lowrank_inputs(m, i, k, o, seed=2)
    h = x @ r.T
    got = tref.lowrank_bwd_ref(*_t(dy, x, h, l_, r))
    want = rref.lowrank_bwd_ref(*(jnp.asarray(a) for a in (dy, x, h, l_, r)))
    for g, w, n in zip(got, want, (o + k, m, o + m)):
        _close(g.numpy(), w, n)


@pytest.mark.parametrize("lead,i,k,o", [((2, 5), 48, 12, 40),
                                        ((7,), 896, 128, 128)])
def test_fused_function_gradients_match_jax_vjp(lead, i, k, o):
    """``ops.lowrank_matmul`` with grad on (the sketch-saving Function) and
    ``jax.vjp`` of the reference's fused op (its custom VJP): the same
    output and the same gradients for x, R and L."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal(lead + (i,)).astype(np.float32)
    r = (rng.standard_normal((k, i)) * i ** -0.5).astype(np.float32)
    l_ = (rng.standard_normal((o, k)) * k ** -0.5).astype(np.float32)
    dy = rng.standard_normal(lead + (o,)).astype(np.float32)
    want_y, vjp = jax.vjp(rops.lowrank_matmul_fused, jnp.asarray(x),
                          jnp.asarray(r), jnp.asarray(l_))
    wdx, wdr, wdl = vjp(jnp.asarray(dy))
    ts = [t.requires_grad_(True) for t in _t(x, r, l_)]
    y = tops.lowrank_matmul(*ts)
    assert "_LowrankFusedBackward" in _graph_nodes(y)
    y.backward(torch.from_numpy(dy))
    m = int(np.prod(lead))
    _close(y.detach().numpy(), want_y, i + k)
    for t, w, n in zip(ts, (wdx, wdr, wdl), (o + k, o + m, m)):
        assert t.grad is not None and t.grad.dtype == t.dtype
        _close(t.grad.numpy(), w, n)


def test_fused_function_keeps_the_factor_dtype_of_the_gradient():
    """dx in x's dtype, dR and dL cast to the factors' dtype (the
    reference's ``ops.py`` backward), bf16 in and out."""
    x, r, l_, dy = (t.to(torch.bfloat16) for t in
                    _t(*_lowrank_inputs(6, 32, 8, 16, seed=4)))
    ts = [t.requires_grad_(True) for t in (x, r, l_)]
    tops.lowrank_matmul(*ts).backward(dy)
    assert all(t.grad.dtype == torch.bfloat16 for t in ts)


# ---------------------------------------------------------------------------
# kernels #5 and #4: Gram and CholeskyQR
# ---------------------------------------------------------------------------

def _tall(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("m,k", [(64, 16), (300, 40), (896, 128)])
def test_gram_plain_version_matches_pallas_gram_kernel(m, k):
    y = _tall((m, k), 5)
    got = tops.gram(torch.from_numpy(y))
    want = rops.gram(jnp.asarray(y))
    _close(got.numpy(), want, m)


def test_gram_plain_version_is_batched():
    y = _tall((3, 50, 8), 6)
    got = tops.gram(torch.from_numpy(y)).numpy()
    for b in range(3):
        _close(got[b], rref.gram_ref(jnp.asarray(y[b])), 50)


@pytest.mark.parametrize("m,k", [(64, 16), (300, 40), (896, 128)])
def test_choleskyqr_plain_version_matches_pallas_choleskyqr_kernel(m, k):
    """Gaussian Y, well conditioned. The Pallas kernel spreads its shift's
    trace over K padded to 128 (a shift up to 128/K times smaller, at the
    1e-6 relative level); Q and mix agree within 1e-4 of their scale."""
    y = _tall((m, k), 7)
    q, mix = tops.choleskyqr_fused(torch.from_numpy(y))
    wq, wmix = rops.choleskyqr_fused(jnp.asarray(y))
    np.testing.assert_allclose(q.numpy(), np.asarray(wq), rtol=0,
                               atol=1e-4 * np.abs(np.asarray(wq)).max())
    np.testing.assert_allclose(mix.numpy(), np.asarray(wmix), rtol=0,
                               atol=1e-4 * np.abs(np.asarray(wmix)).max())
    assert float(torth.orthonormality_error(q)) < 1e-4


def test_cholesky_qr_mix_batched_matches_reference():
    """The CPU dispatch of the refresh: stacked (repeat, O, K) factors, as
    the reference's ``ops.cholesky_qr_mix`` sends them to
    ``cholesky_qr_mix_ref``. Q and mix within 1e-5 of their scale (one f32
    Cholesky of a K x K Gram of 60 terms, K = 12)."""
    y = _tall((4, 60, 12), 8)
    q, mix = tops.cholesky_qr_mix(torch.from_numpy(y))
    wq, wmix = rorth.cholesky_qr_mix_ref(jnp.asarray(y))
    np.testing.assert_allclose(q.numpy(), np.asarray(wq), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(wq)).max())
    np.testing.assert_allclose(mix.numpy(), np.asarray(wmix), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(wmix)).max())


def test_shifted_cholesky_takes_the_ladder_where_the_first_shift_fails():
    """An indefinite Gram: the first shift (1e-6 tr/K) leaves it
    indefinite, the ladder's 1e4-times larger shift does not. JAX flags the
    failure with NaNs and torch with ``info``; both pick the second
    factor."""
    g = np.diag([1.0, 1.0, -1e-4]).astype(np.float32)
    got = torth._shifted_cholesky(torch.from_numpy(g), 1e-6)
    want = rorth._shifted_cholesky(jnp.asarray(g), 1e-6)
    assert np.isfinite(np.asarray(want)).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("fn", ["cholesky_qr", "cholesky_qr2",
                                "gram_schmidt", "orthonormality_error"])
def test_orthogonal_functions_match_reference(fn):
    y = _tall((40, 6), 9)
    got = getattr(torth, fn)(torch.from_numpy(y)).numpy()
    want = np.asarray(getattr(rorth, fn)(jnp.asarray(y)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the WSI refresh and step
# ---------------------------------------------------------------------------

def test_wsi_refresh_factored_on_stacked_pairs_matches_reference():
    """Two stacked layers (the layout of a layer group): the new L
    orthonormal, L R unchanged, both equal to the reference's within 1e-5
    of their scale (an f32 CholeskyQR and a K x K by K x I product)."""
    rng = np.random.default_rng(10)
    l_ = rng.standard_normal((2, 48, 8)).astype(np.float32)
    r = rng.standard_normal((2, 8, 32)).astype(np.float32)
    got = twsi.wsi_refresh_factored(twsi.WSIState(*_t(l_, r)))
    want = rwsi.wsi_refresh_factored(rwsi.WSIState(jnp.asarray(l_),
                                                   jnp.asarray(r)))
    for g, w in ((got.L, want.L), (got.R, want.R)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())
    prod = (got.L @ got.R).numpy()
    np.testing.assert_allclose(prod, l_ @ r, rtol=0,
                               atol=1e-4 * np.abs(l_ @ r).max())
    assert float(torth.orthonormality_error(got.L).max()) < 1e-5


def test_wsi_step_matches_reference():
    rng = np.random.default_rng(11)
    w = rng.standard_normal((2, 24, 20)).astype(np.float32)
    l0 = rng.standard_normal((2, 24, 6)).astype(np.float32)
    r0 = rng.standard_normal((2, 6, 20)).astype(np.float32)
    got = twsi.wsi_step(torch.from_numpy(w), twsi.WSIState(*_t(l0, r0)))
    want = rwsi.wsi_step(jnp.asarray(w), rwsi.WSIState(jnp.asarray(l0),
                                                      jnp.asarray(r0)))
    for g, wt in ((got.L, want.L), (got.R, want.R)):
        wt = np.asarray(wt)
        np.testing.assert_allclose(g.numpy(), wt, rtol=0,
                                   atol=1e-4 * np.abs(wt).max())
    assert twsi.wsi_flops(896, 4864, 256) == rwsi.wsi_flops(896, 4864, 256)


# ---------------------------------------------------------------------------
# loss, clipping, schedule, optimizers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_masked_xent_value_and_gradient_match_reference(dtype):
    """f32: value and gradient within a few ulps (logsumexp over V = 97
    terms). bf16 logits: same value within f32 tolerance (the reductions
    run in f32 on both sides); the gradient is emitted in bf16 on both
    sides, within one bf16 ulp."""
    rng = np.random.default_rng(12)
    logits = (rng.standard_normal((2, 5, 97)) * 3).astype(np.float32)
    labels = rng.integers(0, 97, (2, 5)).astype(np.int32)
    mask = (rng.random((2, 5)) > 0.3).astype(np.float32)
    jl = jnp.asarray(logits, dtype)
    want, wgrad = jax.value_and_grad(rxent)(jl, jnp.asarray(labels),
                                            jnp.asarray(mask))
    tl = torch.from_numpy(np.array(jl.astype(jnp.float32))).to(
        getattr(torch, dtype)).requires_grad_(True)
    got = txent(tl, torch.from_numpy(labels).long(), torch.from_numpy(mask))
    got.backward()
    assert tl.grad.dtype == tl.dtype
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    wg = np.asarray(wgrad, np.float32)
    rtol = 1e-5 if dtype == "float32" else 2.0 ** -7
    np.testing.assert_allclose(tl.grad.float().numpy(), wg, rtol=rtol,
                               atol=1e-7)


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((6, 5)).astype(np.float32),
            "b": rng.standard_normal((7,)).astype(np.float32),
            "c": rng.standard_normal((2, 3, 4)).astype(np.float32)}


def test_clip_and_schedule_match_reference():
    g = {k: v * 3 for k, v in _tree(13).items()}
    got, n = tclip({k: torch.from_numpy(v) for k, v in g.items()}, 2.0)
    want, wn = rclip({k: jnp.asarray(v) for k, v in g.items()}, 2.0)
    np.testing.assert_allclose(float(n), float(wn), rtol=1e-6)
    for k in g:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-7)
    for step in (0, 1, 7, 40):
        np.testing.assert_allclose(
            float(tcosine(step, 0.05, 40, warmup=3)),
            float(rcosine(step, 0.05, 40, warmup=3)), rtol=1e-6)


@pytest.mark.parametrize("opt,momentum", [("sgd", 0.9), ("sgd", 0.0),
                                          ("adamw", 0.0)])
def test_optimizer_update_matches_reference_over_three_steps(opt, momentum):
    """Three updates from the same params and grads: params and moments
    within 1e-6 relative (f32 elementwise math, a few ulps per step)."""
    kw = dict(optimizer=opt, momentum=momentum, lr=0.1, weight_decay=1e-2)
    p0 = _tree(14)
    rparams = {k: jnp.asarray(v) for k, v in p0.items()}
    rstate = rinit_opt(rparams, RTrainConfig(**kw))
    tparams = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    tstate = tinit_opt(tparams, TrainConfig(**kw))
    for s in range(3):
        g = _tree(20 + s)
        lr = 0.1 * (s + 1) / 3
        rparams, rstate = rupdate(rparams, {k: jnp.asarray(v) for k, v in
                                            g.items()}, rstate,
                                  RTrainConfig(**kw), lr)
        tstate = tupdate(tparams, {k: torch.from_numpy(v) for k, v in
                                   g.items()}, tstate, TrainConfig(**kw), lr)
    assert tstate.step == int(rstate.step) == 3
    for k in p0:
        np.testing.assert_allclose(tparams[k].numpy(),
                                   np.asarray(rparams[k]), rtol=1e-6,
                                   atol=1e-7)
        for mine, theirs in ((tstate.mu, rstate.mu), (tstate.nu, rstate.nu)):
            assert (mine is None) == (theirs is None)
            if mine is not None:
                np.testing.assert_allclose(mine[k].numpy(),
                                           np.asarray(theirs[k]),
                                           rtol=1e-6, atol=1e-8)


# ---------------------------------------------------------------------------
# wrappers and launch configuration (no card here)
# ---------------------------------------------------------------------------

def test_training_kernel_wrappers_refuse_cpu_tensors():
    tops.reset_launches()
    x, r, l_, dy = _t(*_lowrank_inputs(8, 32, 8, 16))
    h = x @ r.T
    with pytest.raises(ValueError, match="CUDA tensors only"):
        tlowrank.lowrank_fused(x, r, l_, save_sketch=True)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        tlowrank.lowrank_bwd(dy, x, h, l_, r)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        tgram.gram(x)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        tqr.choleskyqr(x)
    assert set(tops.launch_counts().values()) == {0}


def test_cpu_training_path_counts_no_launch():
    tops.reset_launches()
    x, r, l_, dy = _t(*_lowrank_inputs(8, 32, 8, 16))
    ts = [t.requires_grad_(True) for t in (x, r, l_)]
    tops.lowrank_matmul(*ts).backward(dy)
    tops.cholesky_qr_mix(l_.detach())
    tops.gram(x.detach())
    assert set(tops.launch_counts().values()) == {0}


@pytest.mark.parametrize("m,i,k,o", [(2048, 896, 256, 896),
                                     (2048, 896, 128, 128),
                                     (2048, 896, 256, 4864),
                                     (2048, 4864, 256, 896),
                                     (1000, 70, 5, 33), (3, 9, 2, 5)])
def test_backward_splits_and_workspace_cover_each_product(m, i, k, o):
    """Every product's reduction splits into ranges of >= 256 terms (or
    one range), and the workspace holds every split product's partials."""
    cfg = tlowrank.bwd_config(m, i, k, o)
    prods = {"dh": (m, k, o), "dx": (m, i, k), "dl": (o, k, m),
             "dr": (k, i, m)}
    for name, (rows, cols, red) in prods.items():
        s = getattr(cfg, name)
        assert s >= 1 and (s == 1 or red // s >= 256)
        if s > 1:
            assert cfg.ws >= s * rows * cols
