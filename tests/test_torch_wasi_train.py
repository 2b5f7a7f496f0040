"""The port's ``wasi`` and ``asi`` training methods against the reference's,
on qwen2 smoke in f32: the Tucker-residual custom gradients
(``core.lowrank_linear``), what they save for backward
(``utils.memprof``), and the slice gate, 4 training steps whose params and
ASI states are carried across by ``api.bridge`` from the reference's
``init_lm``/``init_lm_states``, with the reference's ``SyntheticLM``
batches handed across as numpy.

Tolerances (f32 on both sides, sums in other orders):

* ``wasi_matmul``/``asi_matmul``: outputs and every gradient within 1e-5 of
  their scale (two or three contractions).
* The slice gate: losses, ``ce`` and ``ppl_proxy`` within 1e-5 relative,
  grad_norm within 1e-4 relative. The ASI factors are the one place where
  ulps grow: each step's subspace iteration starts from the last step's
  factors, and at smoke ranks (half of each mode) the gap between the kept
  and the dropped singular values is small, so a subspace turns by
  rounding over a few steps. The reference itself shows it: its jit and
  eager runs of the same 4 steps end with factors apart by (max abs, of
  the scale) 4.5e-3 (wasi, AdamW), 8.7e-5 (wasi, SGD), 4.4e-4 (asi,
  AdamW), 1.3e-5 (asi, SGD) (measured on this test's inputs). Each gate
  holds the port's factors to about 4x that: 2e-2, 4e-4, 2e-3, 6e-5 (after
  one step, all within 1e-5). SGD+momentum params within 1e-5 of each
  leaf's scale. AdamW divides each gradient entry by its own running
  magnitude, so an entry at the level of its rounding noise moves its
  param by up to ~lr in either package, and the turning subspaces add
  their share: the reference's own jit and eager runs end with params
  apart by 8.2e-4 (wasi) and 7.1e-4 (asi) of a leaf's scale. AdamW params
  are held to 0.3 lr = 3e-3 absolute (about 4x that; 4 steps move a param
  by up to 4 lr), moments to 1e-3 of their scale.
* Microbatches: batch 8 in two slices of 4 (the gates' per-pass shape),
  SGD, 2 steps: factors within 1e-4 (the reference's jit against eager:
  1.9e-5), params within 1e-5. At batch 4 in slices of 2 the reference's
  own jit and eager runs end with factors apart by 1.6 of their scale, so
  that shape cannot hold anything to the reference.
* Residual bytes are counts: equal, no tolerance.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as rconfigs
import repro.core.asi as rasi
import repro.core.lowrank_linear as rll
import repro.models.lm as rlm
import repro.utils.memprof as rmem
import repro_torch.configs as tconfigs
import repro_torch.core.asi as tasi
import repro_torch.core.lowrank_linear as tll
import repro_torch.models.lm as tlm
import repro_torch.utils.memprof as tmem
from repro import api as rapi
from repro.checkpoint import restore_checkpoint as rrestore
from repro.checkpoint import save_checkpoint as rsave
from repro.config import TrainConfig as RTrainConfig
from repro.data.synthetic import SyntheticLM as RSyntheticLM
from repro.train.step import make_train_state as rmake_state
from repro.train.step import make_train_step as rmake_step
from repro_torch import api as tapi
from repro_torch.api.bridge import (
    from_reference,
    state_from_reference,
    state_to_reference,
    states_from_reference,
)
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.config import TrainConfig
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.kernels import ops
from repro_torch.launch import train as tlaunch
from repro_torch.launch.serve import generate
from repro_torch.train.step import make_train_state, make_train_step

torch.set_num_threads(1)
KEY = jax.random.PRNGKey(0)
B, S, STEPS = 4, 16, 4


def _cfgs(method, refresh=2):
    def m(c):
        return c.replace(wasi=dataclasses.replace(
            c.wasi, method=method, refresh_every=refresh))
    return (m(rconfigs.get_smoke("qwen2-0.5b")),
            m(tconfigs.get_smoke("qwen2-0.5b")))


def _install(rcfg, tcfg):
    rapi.uninstall(rcfg)
    tapi.uninstall(tcfg)
    rapi.install(rapi.resolve(rcfg, batch=B, seq=S))
    tapi.install(tapi.resolve(tcfg, batch=B, seq=S))


def _batches(rcfg, n, batch=B):
    data = RSyntheticLM(vocab_size=rcfg.vocab_size, seq_len=S,
                        global_batch=batch, seed=1)
    return [jax.tree.map(np.asarray, data.batch(i)) for i in range(n)]


def _torch_batch(b):
    return {k: torch.tensor(v).long() for k, v in b.items()}


def _close(got, want, rel):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30))


def _tree_close(got, want, rel, abs_=0.0):
    fg, tg = jax.tree.flatten(got)
    fw, tw = jax.tree.flatten(jax.tree.map(np.asarray, want))
    assert tg == tw
    for g, w in zip(fg, fw):
        np.testing.assert_allclose(
            g, w, rtol=0, atol=rel * max(np.abs(w).max(), 1e-30) + abs_)


def _as_ref(node):
    """Port ASI states (numpy or tensor leaves) -> the reference's
    ``ASIState`` tree, for the tree comparisons."""
    if isinstance(node, tasi.ASIState):
        return rasi.ASIState(us=tuple(node.us))
    if isinstance(node, dict):
        return {k: _as_ref(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_as_ref(v) for v in node]
    return node


# ---------------------------------------------------------------------------
# the custom gradients
# ---------------------------------------------------------------------------

def _factors(rng, shape, ranks):
    a = rng.standard_normal(shape).astype(np.float32)
    us = [None if r >= d else
          np.linalg.qr(rng.standard_normal((d, r)))[0].astype(np.float32)
          for d, r in zip(shape, ranks)]
    rf = rasi.asi_project(jnp.asarray(a), rasi.ASIState(
        us=tuple(None if u is None else jnp.asarray(u) for u in us)))
    tf = tasi.TuckerFactors(
        core=torch.tensor(np.asarray(rf.core)),
        us=tuple(None if u is None else torch.from_numpy(u) for u in us))
    return a, rf, tf


MATMUL_CASES = [((4, 16, 32), (4, 8, 12)), ((6, 16, 32), (3, 8, 12)),
                ((4, 16, 32), (4, 8, 32)), ((3, 4, 5, 20), (3, 2, 3, 8))]


@pytest.mark.parametrize("shape,ranks", MATMUL_CASES)
def test_wasi_matmul_forward_and_gradients_match_reference(shape, ranks):
    rng = np.random.default_rng(sum(shape))
    a, rf, tf = _factors(rng, shape, ranks)
    i, k, o = shape[-1], 6, 10
    l_ = rng.standard_normal((o, k)).astype(np.float32)
    r = rng.standard_normal((k, i)).astype(np.float32)
    dy = rng.standard_normal(shape[:-1] + (o,)).astype(np.float32)
    y, vjp = jax.vjp(lambda x, lf, rr: rll.wasi_matmul(x, lf, rr, rf),
                     jnp.asarray(a), jnp.asarray(l_), jnp.asarray(r))
    want = (y,) + vjp(jnp.asarray(dy))
    ts = [torch.from_numpy(t).requires_grad_(True) for t in (a, l_, r)]
    got = tll.wasi_matmul(*ts, tf)
    got.backward(torch.from_numpy(dy))
    for g, w in zip([got] + [t.grad for t in ts], want):
        _close(g.detach().numpy(), w, 1e-5)


@pytest.mark.parametrize("shape,ranks", MATMUL_CASES)
def test_asi_matmul_forward_and_gradients_match_reference(shape, ranks):
    rng = np.random.default_rng(sum(shape) + 1)
    a, rf, tf = _factors(rng, shape, ranks)
    w = rng.standard_normal((9, shape[-1])).astype(np.float32)
    dy = rng.standard_normal(shape[:-1] + (9,)).astype(np.float32)
    y, vjp = jax.vjp(lambda x, ww: rll.asi_matmul(x, ww, rf),
                     jnp.asarray(a), jnp.asarray(w))
    want = (y,) + vjp(jnp.asarray(dy))
    ts = [torch.from_numpy(t).requires_grad_(True) for t in (a, w)]
    got = tll.asi_matmul(*ts, tf)
    got.backward(torch.from_numpy(dy))
    for g, ww in zip([got] + [t.grad for t in ts], want):
        _close(g.detach().numpy(), ww, 1e-5)


def test_wasi_linear_apply_threads_the_state():
    g = torch.Generator().manual_seed(0)
    p = tll.init_wasi_linear(g, 32, 24, 8, bias=True)
    st = tasi.asi_init(g, (4, 16, 32), (4, 8, 12))
    x = torch.randn(4, 16, 32, generator=g)
    y, ns = tll.wasi_linear_apply(p, x, st)
    assert y.shape == (4, 16, 24) and ns.us[0] is None
    assert not torch.equal(ns.us[2], st.us[2])
    y0, none = tll.wasi_linear_apply(p, x, None)
    assert none is None
    torch.testing.assert_close(y, y0, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# what is saved for backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,ranks", MATMUL_CASES)
def test_residual_bytes_of_one_site_equal_the_reference(shape, ranks):
    """The reference's ``jax.vjp`` probe and the port's saved-tensor hooks
    count the same bytes: the Tucker factors, h~'s last factor, L and R
    (``wasi_matmul``), the factors and W (``asi_matmul``); never x."""
    rng = np.random.default_rng(2)
    a, rf, tf = _factors(rng, shape, ranks)
    l_ = rng.standard_normal((10, 6)).astype(np.float32)
    r = rng.standard_normal((6, shape[-1])).astype(np.float32)
    w = l_ @ r
    want = rmem.measured_residual_bytes(
        lambda x, lf, rr: rll.wasi_matmul(x, lf, rr, rf), jnp.asarray(a),
        jnp.asarray(l_), jnp.asarray(r))
    x = torch.from_numpy(a)
    got = tmem.measured_residual_bytes(
        lambda x_, lf, rr: tll.wasi_matmul(x_, lf, rr, tf), x,
        torch.from_numpy(l_), torch.from_numpy(r))
    assert (got.total_bytes, got.n_arrays) == (want.total_bytes,
                                               want.n_arrays)
    assert x.untyped_storage().data_ptr() not in got.storages
    last = tf.us[-1]
    sketch = 6 * (last.shape[1] if last is not None else shape[-1])
    assert got.total_bytes == 4 * (tf.core.numel() + sum(
        u.numel() for u in tf.us if u is not None) + sketch
        + l_.size + r.size) - (4 * r.size if last is None else 0)
    want = rmem.measured_residual_bytes(
        lambda x, ww: rll.asi_matmul(x, ww, rf), jnp.asarray(a),
        jnp.asarray(w))
    got = tmem.measured_residual_bytes(
        lambda x_, ww: tll.asi_matmul(x_, ww, tf), x, torch.from_numpy(w))
    assert (got.total_bytes, got.n_arrays) == (want.total_bytes,
                                               want.n_arrays)
    assert x.untyped_storage().data_ptr() not in got.storages


def _lm_residual_bytes(method):
    rcfg, tcfg = _cfgs(method)
    _install(rcfg, tcfg)
    params = rlm.init_lm(KEY, rcfg)
    st = rlm.init_lm_states(KEY, rcfg, B, S) if rcfg.wasi.compress_acts \
        else None
    batch = _batches(rcfg, 1)[0]
    want = rmem.measured_residual_bytes(
        lambda p: rlm.lm_loss(p, jax.tree.map(jnp.asarray, batch), rcfg,
                              states=st), params, has_aux=True).total_bytes
    model = from_reference(jax.tree.map(np.asarray, params), tcfg, "cpu",
                           trainable=True)
    tst = None if st is None else states_from_reference(
        jax.tree.map(np.asarray, st), "cpu")
    got = tmem.measured_residual_bytes(
        lambda: tlm.lm_loss(model, _torch_batch(batch), tcfg,
                            states=tst)).total_bytes
    return got, want


def test_lm_loss_residual_bytes_move_with_the_method_as_the_reference():
    """One smoke ``lm_loss`` under each method. The linear sites save the
    same bytes in both packages, so what each method adds or removes
    against ``none`` is equal to the byte. The rest of the model
    (attention, norms, SwiGLU, the cross-entropy) saves other tensors in
    each framework, and JAX's scan stacks its residuals per layer group:
    a constant offset, the same for every method (ROADMAP.md queue 3)."""
    out = {m: _lm_residual_bytes(m) for m in ("none", "asi", "wsi", "wasi")}
    offsets = {m: w - g for m, (g, w) in out.items()}
    assert len(set(offsets.values())) == 1, offsets
    for m, (g, w) in out.items():
        assert g - out["none"][0] == w - out["none"][1], m


# ---------------------------------------------------------------------------
# the slice gate
# ---------------------------------------------------------------------------

GATES = {"adamw": dict(optimizer="adamw", lr=1e-2, weight_decay=1e-4),
         "sgd_momentum": dict(optimizer="sgd", lr=0.3, momentum=0.9)}


def _gate(method, gate, *, microbatch=1, steps=STEPS, batch=B):
    rcfg, tcfg = _cfgs(method)
    _install(rcfg, tcfg)
    kw = dict(GATES[gate], steps=steps, clip_norm=2.0, checkpoint_every=0,
              microbatch=microbatch)
    rtc, ttc = RTrainConfig(**kw), TrainConfig(**kw)
    params = rlm.init_lm(KEY, rcfg)
    st = rlm.init_lm_states(KEY, rcfg, batch // microbatch, S)
    rstate = rmake_state(KEY, params, rcfg, rtc, asi_states=st)
    state = state_from_reference(jax.tree.map(np.asarray, rstate), tcfg,
                                 "cpu")
    rstep = jax.jit(rmake_step(rlm.lm_loss, rcfg, rtc))
    step = make_train_step(tlm.lm_loss, tcfg, ttc)
    for i, b in enumerate(_batches(rcfg, steps, batch)):
        rstate, rm = rstep(rstate, jax.tree.map(jnp.asarray, b))
        state, m = step(state, _torch_batch(b))
        for k in ("loss", "grad_norm", "lr", "ce", "ppl_proxy"):
            rtol = 1e-4 if k == "grad_norm" else 1e-5
            np.testing.assert_allclose(float(m[k]), float(rm[k]), rtol=rtol,
                                       err_msg=f"step {i} {k}")
    return rstate, state


ASI_TOL = {("wasi", "adamw"): 2e-2, ("wasi", "sgd_momentum"): 4e-4,
           ("asi", "adamw"): 2e-3, ("asi", "sgd_momentum"): 6e-5}


@pytest.mark.parametrize("gate", sorted(GATES))
@pytest.mark.parametrize("method", ["wasi", "asi"])
def test_asi_training_matches_reference_train_step(method, gate):
    rstate, state = _gate(method, gate)
    assert state.step == int(rstate.step) == STEPS
    out = state_to_reference(state)
    _tree_close(_as_ref(out["asi"]), rstate.asi, ASI_TOL[method, gate])
    if gate == "adamw":
        _tree_close(out["params"], rstate.params, 0.0,
                    0.3 * GATES[gate]["lr"])
        _tree_close(out["mu"], rstate.opt.mu, 1e-3)
        _tree_close(out["nu"], rstate.opt.nu, 1e-3)
    else:
        _tree_close(out["params"], rstate.params, 1e-5)
        _tree_close(out["mu"], rstate.opt.mu, 1e-5)


def test_asi_states_carry_across_microbatches_as_the_reference():
    rstate, state = _gate("wasi", "sgd_momentum", microbatch=2, steps=2,
                          batch=8)
    out = state_to_reference(state)
    _tree_close(out["params"], rstate.params, 1e-5)
    _tree_close(_as_ref(out["asi"]), rstate.asi, 1e-4)


def test_states_cross_the_bridge_in_the_reference_layout():
    """``init_lm_states`` of both packages: one tree, identity modes None,
    stacked on ``repeat``; the bridge keeps JAX's flatten order."""
    rcfg, tcfg = _cfgs("wasi")
    _install(rcfg, tcfg)
    rst = rlm.init_lm_states(KEY, rcfg, B, S)
    tst = tlm.init_lm_states(tcfg, B, S, device="cpu")
    shapes = jax.tree.map(lambda x: tuple(x.shape), rst)
    assert jax.tree.map(lambda x: tuple(x.shape), _as_ref(
        jax.tree.map(lambda t: t.numpy(), tst,
                     is_leaf=lambda n: isinstance(n, torch.Tensor)))) \
        == shapes
    back = states_from_reference(jax.tree.map(np.asarray, rst), "cpu")
    assert jax.tree.structure(_as_ref(back)) == jax.tree.structure(rst)
    for a, b in zip(jax.tree.leaves(_as_ref(back)), jax.tree.leaves(rst)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ---------------------------------------------------------------------------
# after training: decode, checkpoints, the launcher
# ---------------------------------------------------------------------------

def test_decode_after_training_generates():
    """The port's counterpart of tests/test_system.py's: 30 smoke steps
    under the config's ``wasi`` method, then greedy generation."""
    cfg = tconfigs.get_smoke("qwen2-0.5b")
    assert cfg.wasi.method == "wasi"
    tapi.uninstall(cfg)
    tapi.install(tapi.resolve(cfg))
    b, s = 8, 32
    tcfg = TrainConfig(optimizer="sgd", lr=0.3, momentum=0.9, steps=30,
                       clip_norm=2.0, checkpoint_every=0)
    model = tlm.init_lm(cfg, device="cpu", seed=233)
    state = make_train_state(model, cfg, tcfg, asi_states=tlm.init_lm_states(
        cfg, b, s, device="cpu", seed=233))
    step = make_train_step(tlm.lm_loss, cfg, tcfg)
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=s,
                               global_batch=b, seed=1)
    losses = []
    for i in range(30):
        state, m = step(state, data.batch(i))
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    model.requires_grad_(False)
    out = generate(model, cfg, torch.zeros(2, 4, dtype=torch.long),
                   max_cache=16, n_new=8)
    assert out.shape == (2, 12)
    assert bool((out >= 0).all()) and bool((out < cfg.vocab_size).all())


def test_wasi_checkpoint_crosses_both_ways(tmp_path):
    """A ``train_state`` with ASI states written by either package and
    read by the other: every ASI leaf byte-identical, in the reference's
    flatten order (identity modes add no leaf)."""
    rcfg, tcfg = _cfgs("wasi")
    _install(rcfg, tcfg)
    rtc = RTrainConfig(optimizer="sgd", lr=0.1, momentum=0.9, steps=1)
    ttc = TrainConfig(optimizer="sgd", lr=0.1, momentum=0.9, steps=1)
    params = rlm.init_lm(KEY, rcfg)
    rstate = rmake_state(KEY, params, rcfg, rtc,
                         asi_states=rlm.init_lm_states(KEY, rcfg, B, S))
    rstate, _ = jax.jit(rmake_step(rlm.lm_loss, rcfg, rtc))(
        rstate, jax.tree.map(jnp.asarray, _batches(rcfg, 1)[0]))
    # reference -> port
    rsave(str(tmp_path / "ref"), 1, rstate)
    template = state_from_reference(jax.tree.map(np.asarray, rstate), tcfg,
                                    "cpu")
    template = template._replace(asi=jax.tree.map(
        torch.zeros_like, template.asi,
        is_leaf=lambda n: isinstance(n, torch.Tensor)))
    got = restore_checkpoint(str(tmp_path / "ref"), 1, template)
    for a, b in zip(jax.tree.leaves(_as_ref(
            state_to_reference(got)["asi"])), jax.tree.leaves(rstate.asi)):
        assert a.tobytes() == np.asarray(b).tobytes()
    # port -> reference
    model = from_reference(jax.tree.map(np.asarray, params), tcfg, "cpu")
    state = make_train_state(model, tcfg, ttc, asi_states=tlm.init_lm_states(
        tcfg, B, S, device="cpu", seed=5))
    state, _ = make_train_step(tlm.lm_loss, tcfg, ttc)(
        state, _torch_batch(_batches(rcfg, 1)[0]))
    save_checkpoint(str(tmp_path / "port"), 1, state)
    back = rrestore(str(tmp_path / "port"), 1, rstate)
    want = _as_ref(state_to_reference(state)["asi"])
    assert jax.tree.structure(back.asi) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(back.asi), jax.tree.leaves(want)):
        assert np.asarray(a).tobytes() == b.tobytes()


def test_launcher_trains_the_config_method_and_logs_memory(capsys):
    """Without ``--wasi`` the launcher trains the smoke config's own
    method, ``wasi``, on the CPU, and ``--memprof`` adds the measured
    memory columns (no device peak on the CPU); ``--wasi asi`` trains
    too. No kernel launches on the CPU."""
    ops.reset_launches()
    hist = tlaunch.main(["--device", "cpu", "--arch", "qwen2-0.5b",
                         "--steps", "2", "--batch", "2", "--seq", "8",
                         "--memprof"])
    assert "wasi=wasi" in capsys.readouterr().out
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)
    for h in hist:
        assert h["mem_live_mib"] > 0
        assert h["mem_live_peak_mib"] >= h["mem_live_mib"]
        assert "mem_dev_peak_mib" not in h
    hist = tlaunch.main(["--device", "cpu", "--arch", "qwen2-0.5b",
                         "--steps", "2", "--batch", "2", "--seq", "8",
                         "--wasi", "asi"])
    assert "wasi=asi" in capsys.readouterr().out
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)
    assert set(ops.launch_counts().values()) == {0}
