"""Training the Mamba families in the port: ``ops._SSDScan`` (kernel #8's
forward, a plain chunked backward) and the 4-step training gate of
zamba2 and falcon-mamba smoke against the reference's ``make_train_step``.

* ``_SSDScan`` driven down the card's branch on the CPU, the kernel's
  wrapper replaced by the plain version it is held to: forward bit-equal
  to the plain scan, one counted launch a forward and none in the
  backward; every gradient (u, dt, A, B, C, D; f32 and bf16 inputs, ragged
  S, one to three chunks) against autograd through the plain version.
  The backward recomputes the same chunk ops in the same order, so in f32
  the gradients agree to 1e-6 of their scale (measured: bit-equal); bf16
  inputs get their gradients back in bf16, summed in f32 (the scan's and
  D.u's for u) and rounded once, at most half an ulp, 2^-8 of the value
  and so of the scale: held to 2^-8 of it. The final state's gradient
  (``return_final`` under autograd, a prefill's) is carried in too.
* The plain backward masks the decay block above the diagonal before its
  exp, so a chunk whose decay sum passes f32's exp range keeps finite
  gradients, where the reference's ``_ssd_chunked`` gives NaN; below that
  range the gradients equal ``jax.grad``'s (2e-5 of their scale).
* ``remat="block"`` against ``"none"`` on falcon-mamba smoke (the scan's
  own chunk checkpoints nested in the block's): loss, gradients and ASI
  states bit-equal; under ``block`` zamba2's scan runs twice a layer (the
  recompute), its backward never.
* The gate: 4 steps of ``make_train_step`` under ``wasi`` and ``wsi``,
  SGD with momentum (lr 0.3), from the reference's params and ASI states
  (``api.bridge``) on its ``SyntheticLM`` batches. These smoke models
  amplify rounding more than qwen2 smoke's, and the reference itself
  shows it: its eager and jitted runs of the same 4 steps end apart by
  (largest over the four cases, of the scale) 6.0e-5 in grad_norm, 7.7e-6
  in ppl_proxy, 1.3e-6 in the loss, 4.7e-5 in the params, 3.1e-4 in the
  momenta, and in the ASI factors 6.6e-4 (zamba2) and 0.17 (falcon-mamba,
  whose smoke ranks leave a small gap between kept and dropped singular
  values, so the subspaces turn). Each quantity is held to about 4x that,
  as ``tests/test_torch_wasi_train.py`` holds qwen2's: the loss and ``ce``
  within 1e-5 relative, ppl_proxy 3e-5, grad_norm 2.5e-4, params 2e-4 and
  momenta 1.3e-3 of each leaf's scale, ASI factors 3e-3 (zamba2) and 0.7
  (falcon-mamba). The port's measured gaps: 1.8e-4, 1.2e-5, 2.0e-6,
  6.8e-5, 9.8e-4, 6.6e-4 and 0.041.
"""
import dataclasses
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as rconfigs
import repro.core.asi as rasi
import repro.models.lm as rlm
import repro.nn.mamba as rmamba
import repro_torch.configs as tconfigs
import repro_torch.core.asi as tasi
import repro_torch.models.lm as tlm
from repro import api as rapi
from repro.config import TrainConfig as RTrainConfig
from repro.data.synthetic import SyntheticLM as RSyntheticLM
from repro.train.step import make_train_state as rmake_state
from repro.train.step import make_train_step as rmake_step
from repro_torch import api as tapi
from repro_torch.api.bridge import state_from_reference, state_to_reference
from repro_torch.config import TrainConfig
from repro_torch.kernels import ops, ref
from repro_torch.train.step import make_train_step, value_and_grad

torch.set_num_threads(1)
KEY = jax.random.PRNGKey(0)
B, S, STEPS = 4, 16, 4
FAMILIES = ("zamba2-7b", "falcon-mamba-7b")

# (Bz, S, H, dh, N, chunk): one chunk, two, a ragged third
SSD_CASES = [(2, 16, 2, 8, 4, 16), (1, 32, 3, 8, 8, 16), (2, 37, 2, 16, 4, 16)]


def _ssd_inputs(bz, s, h, dh, n, seed, decay=1.0):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((bz, s, h, dh)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((bz, s, h)))).astype(np.float32)
    a = (-decay * np.exp(0.3 * rng.standard_normal(h))).astype(np.float32)
    b = rng.standard_normal((bz, s, n)).astype(np.float32)
    c = rng.standard_normal((bz, s, n)).astype(np.float32)
    d = rng.standard_normal(h).astype(np.float32)
    return u, dt, a, b, c, d


def _card_branch(monkeypatch) -> Counter:
    """Send CPU tensors down ``ops.ssd_scan``'s card branch, the kernel's
    wrapper replaced by the plain version, counting its calls."""
    calls: Counter = Counter()

    def kernel(u, dt, A, B, C, chunk):
        calls["ssd_scan"] += 1
        return ref.ssd_scan_ref(u, dt, A, B, C, chunk)

    monkeypatch.setattr(ops, "_on_cpu", lambda t: False)
    monkeypatch.setattr(ops, "ssd_scan_cuda", kernel)
    return calls


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("bz,s,h,dh,n,chunk", SSD_CASES)
def test_ssd_scan_card_branch_backward_matches_plain_autograd(
        monkeypatch, bz, s, h, dh, n, chunk, dtype):
    args = _ssd_inputs(bz, s, h, dh, n, s + h)
    calls = _card_branch(monkeypatch)
    mk = [lambda a: torch.from_numpy(a).to(dtype).requires_grad_(),
          lambda a: torch.from_numpy(a).requires_grad_()]
    # u, B and C in the model's dtype; dt, A and D f32, as the mixer
    # hands them over
    ts = [mk[0 if i in (0, 3, 4) else 1](a) for i, a in enumerate(args)]
    y = ops.ssd_scan(*ts, chunk)
    assert calls == {"ssd_scan": 1}
    w = torch.from_numpy(np.random.default_rng(2).standard_normal(
        y.shape).astype(np.float32))
    got = torch.autograd.grad((y * w).sum(), ts)
    assert calls == {"ssd_scan": 1}          # the backward launches nothing
    # plain autograd on f32 copies of the same values
    fs = [t.detach().float().requires_grad_() for t in ts]
    want_y = ref.ssd_scan_ref(*fs[:5], chunk)[0] \
        + fs[5][None, None, :, None] * fs[0]
    assert torch.equal(y, want_y.detach())
    want = torch.autograd.grad((want_y * w).sum(), fs)
    rel = 1e-6 if dtype == torch.float32 else 2 ** -8
    for name, g, wg, t in zip("u dt A B C D".split(), got, want, ts):
        assert g.dtype == t.dtype, name
        scale = float(wg.abs().max())
        err = float((g.float() - wg).abs().max())
        assert err <= rel * scale, (name, err, scale)


def test_ssd_scan_card_branch_final_state_gradient(monkeypatch):
    """``return_final`` with grad (a prefill under autograd): the final
    state's gradient reaches u, dt, A, B, C through ``_SSDScan`` as
    through plain autograd, ragged S over three chunks, one counted
    launch."""
    args = _ssd_inputs(2, 37, 2, 8, 4, 5)
    calls = _card_branch(monkeypatch)
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    y, final = ops.ssd_scan(*ts, 16, return_final=True)
    assert calls == {"ssd_scan": 1}
    rng = np.random.default_rng(6)
    wy, wf = (torch.from_numpy(rng.standard_normal(t.shape)
                               .astype(np.float32)) for t in (y, final))
    got = torch.autograd.grad((y * wy).sum() + (final * wf).sum(), ts)
    fs = [t.detach().clone().requires_grad_() for t in ts]
    py, pf = ref.ssd_scan_ref(*fs[:5], 16)
    assert torch.equal(final, pf.detach())
    want = torch.autograd.grad(
        ((py + fs[5][None, None, :, None] * fs[0]) * wy).sum()
        + (pf * wf).sum(), fs)
    for name, g, wg in zip("u dt A B C D".split(), got, want):
        scale = float(wg.abs().max())
        assert float((g - wg).abs().max()) <= 1e-6 * scale, name


@pytest.mark.parametrize("decay", [1.0, 40.0], ids=["in_range", "past_exp"])
def test_ssd_scan_gradients_against_jax_grad(decay):
    """In range: every gradient within 2e-5 of its scale of ``jax.grad``
    of the reference's ``_ssd_chunked``. Past f32's exp range above the
    diagonal (decay sums over 88 within a chunk of 32): the port's stay
    finite and equal autograd of a float64 run of the same formula to
    1e-3 of their scale (measured: 2.9e-4 for A, whose gradient is a sum
    of terms of both signs far larger than itself, 1.1e-6 for the
    others), while the reference's ``where(tri, exp(li), 0)`` gives
    NaN."""
    args = _ssd_inputs(2, 64, 2, 8, 4, 3, decay)
    chunk = 32
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    y = ops.ssd_scan(*ts, chunk)
    w = np.random.default_rng(4).standard_normal(y.shape).astype(np.float32)
    got = torch.autograd.grad((y * torch.from_numpy(w)).sum(), ts)
    want = jax.grad(lambda *x: jnp.sum(rmamba._ssd_chunked(*x, chunk) * w),
                    argnums=tuple(range(6)))(*map(jnp.asarray, args))
    if decay > 1:
        assert any(np.isnan(np.asarray(g)).any() for g in want)
        ds = [torch.from_numpy(a).double().requires_grad_() for a in args]
        want = _f64_grads(ds, w, chunk)
        rel = 1e-3
    else:
        rel = 2e-5
    for name, g, wg in zip("u dt A B C D".split(), got, want):
        wg = np.asarray(wg, np.float64)
        assert np.isfinite(g.numpy()).all(), name
        scale = max(float(np.abs(wg).max()), 1e-30)
        err = float(np.abs(g.numpy() - wg).max())
        assert err <= rel * scale, (name, err, scale)


def _f64_grads(ds, w, chunk):
    """Gradients of sum(w * (scan + D.u)) in float64, one chunk at a time
    from ``ref.ssd_chunk_ref`` (the port's masked formula)."""
    u, dt, a, b, c, d = ds
    state = torch.zeros((u.shape[0], u.shape[2], u.shape[3], b.shape[-1]),
                        dtype=torch.float64)
    ys = []
    for c0 in range(0, u.shape[1], chunk):
        sl = slice(c0, c0 + chunk)
        y, state = ref.ssd_chunk_ref(u[:, sl], dt[:, sl], a, b[:, sl],
                                     c[:, sl], state)
        ys.append(y)
    y = torch.cat(ys, 1) + d[None, None, :, None] * u
    return [g.numpy() for g in torch.autograd.grad(
        (y * torch.from_numpy(w).double()).sum(), ds)]


# ---------------------------------------------------------------------------
# remat="block" with the Mamba kinds
# ---------------------------------------------------------------------------

def _port(arch, method, remat, s=S, seed=0):
    c = tconfigs.get_smoke(arch)
    cfg = c.replace(remat=remat, wasi=dataclasses.replace(
        c.wasi, method=method, refresh_every=2))
    tapi.uninstall(cfg)
    tapi.install(tapi.resolve(cfg, batch=B, seq=s))
    model = tlm.init_lm(cfg, device="cpu", seed=seed)
    model.requires_grad_(True)
    states = (tlm.init_lm_states(cfg, B, s, device="cpu", seed=seed)
              if cfg.wasi.compress_acts else None)
    return cfg, model, states


def _batch(s=S):
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, 256, (B, s), generator=g)
    return {"tokens": toks, "labels": torch.roll(toks, -1, 1)}


def test_falcon_mamba_block_equals_none_bit_for_bit():
    """The body is one ``mamba1`` layer, its scan's chunk checkpoints
    nested inside the block's; S = 256 gives the scan two chunks."""
    out = {}
    for remat in ("none", "block"):
        cfg, model, states = _port("falcon-mamba-7b", "wasi", remat, 256)
        out[remat] = value_and_grad(tlm.lm_loss, model, _batch(256), cfg,
                                    states)
    (l0, _, g0, s0), (l1, _, g1, s1) = out["none"], out["block"]
    assert torch.equal(l0, l1)
    assert g0.keys() == g1.keys()
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k
    a, b = [], []
    tlm.map_states(a.append, s0)
    tlm.map_states(b.append, s1)
    assert len(a) == len(b) > 0
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_zamba2_block_recomputes_the_scan_and_its_backward_launches_none(
        monkeypatch):
    """Per training step of L Mamba-2 layers the scan's forward runs L
    times under ``none`` and 2 L under ``block`` (the recompute), counted
    through the plain version the wrapper calls on the CPU; the backward
    never runs it (it recomputes chunk by chunk)."""
    calls: Counter = Counter()
    fn = ref.ssd_scan_ref

    def counted(*a, **kw):
        calls["ssd_scan"] += 1
        return fn(*a, **kw)

    monkeypatch.setattr(ref, "ssd_scan_ref", counted)
    got = {}
    for remat in ("none", "block"):
        cfg, model, states = _port("zamba2-7b", "wasi", remat)
        calls.clear()
        loss, _, grads, _ = value_and_grad(tlm.lm_loss, model, _batch(), cfg,
                                           states)
        got[remat] = dict(calls)
        assert all(torch.isfinite(g).all() for g in grads.values())
    assert got == {"none": {"ssd_scan": cfg.n_layers},
                   "block": {"ssd_scan": 2 * cfg.n_layers}}


# ---------------------------------------------------------------------------
# the gate: 4 steps against the reference's make_train_step
# ---------------------------------------------------------------------------

def _cfgs(arch, method):
    def m(c):
        return c.replace(wasi=dataclasses.replace(
            c.wasi, method=method, refresh_every=2))
    return m(rconfigs.get_smoke(arch)), m(tconfigs.get_smoke(arch))


def _as_ref(node):
    if isinstance(node, tasi.ASIState):
        return rasi.ASIState(us=tuple(node.us))
    if isinstance(node, dict):
        return {k: _as_ref(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_as_ref(v) for v in node]
    return node


def _tree_close(got, want, rel):
    fg, tg = jax.tree.flatten(got)
    fw, tw = jax.tree.flatten(jax.tree.map(np.asarray, want))
    assert tg == tw
    for g, w in zip(fg, fw):
        np.testing.assert_allclose(
            g, w, rtol=0, atol=rel * max(np.abs(w).max(), 1e-30))


GATE_RTOL = {"loss": 1e-5, "ce": 1e-5, "ppl_proxy": 3e-5, "grad_norm": 2.5e-4}
ASI_TOL = {"zamba2-7b": 3e-3, "falcon-mamba-7b": 0.7}


@pytest.mark.parametrize("method", ["wasi", "wsi"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_training_matches_reference_train_step(arch, method):
    rcfg, tcfg = _cfgs(arch, method)
    rapi.uninstall(rcfg)
    tapi.uninstall(tcfg)
    rapi.install(rapi.resolve(rcfg, batch=B, seq=S))
    tapi.install(tapi.resolve(tcfg, batch=B, seq=S))
    kw = dict(optimizer="sgd", lr=0.3, momentum=0.9, steps=STEPS,
              clip_norm=2.0, checkpoint_every=0)
    rtc, ttc = RTrainConfig(**kw), TrainConfig(**kw)
    states = (rlm.init_lm_states(KEY, rcfg, B, S) if method == "wasi"
              else None)
    rstate = rmake_state(KEY, rlm.init_lm(KEY, rcfg), rcfg, rtc,
                         asi_states=states)
    state = state_from_reference(jax.tree.map(np.asarray, rstate), tcfg,
                                 "cpu")
    rstep = jax.jit(rmake_step(rlm.lm_loss, rcfg, rtc))
    step = make_train_step(tlm.lm_loss, tcfg, ttc)
    data = RSyntheticLM(vocab_size=rcfg.vocab_size, seq_len=S,
                        global_batch=B, seed=1)
    ops.reset_launches()
    for i in range(STEPS):
        b = jax.tree.map(np.asarray, data.batch(i))
        rstate, rm = rstep(rstate, jax.tree.map(jnp.asarray, b))
        state, m = step(state, {k: torch.tensor(v).long()
                                for k, v in b.items()})
        for k, rtol in GATE_RTOL.items():
            np.testing.assert_allclose(float(m[k]), float(rm[k]), rtol=rtol,
                                       err_msg=f"step {i} {k}")
    assert set(ops.launch_counts().values()) == {0}
    out = state_to_reference(state)
    _tree_close(out["params"], rstate.params, 2e-4)
    _tree_close(out["mu"], rstate.opt.mu, 1.3e-3)
    if method == "wasi":
        _tree_close(_as_ref(out["asi"]), rstate.asi, ASI_TOL[arch])
