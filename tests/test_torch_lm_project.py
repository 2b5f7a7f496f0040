"""Project-mode WASI (paper Eq. 9-11, Alg. 1) on a decoder LM against the
reference's, on tinyllama smoke in f32, the paper's flow end to end:

    dense weights -> api.resolve(cfg, calibration=dense)   (epsilon ranks)
    -> api.convert.factorize (project layout {w, L, R})
    -> make_train_state (the factors become warm WSI states)
    -> make_train_step(lm_loss) (factored forward, gradient on W, one WSI
       step per site after the optimizer)
    -> convert.factorize under the calibrated plan in factored mode
    -> a plan-bearing checkpoint -> ServeEngine.from_checkpoint

Each package runs its own calibration, conversion and train state from the
reference's ``init_lm`` draws (method ``none``) and ASI states, and the
reference's ``SyntheticLM`` batches, handed across as numpy.

Singular vectors are defined up to sign (and, where two singular values
nearly meet, up to a rotation between them), and the two packages'
LAPACK builds pick other ones, so each WSI state is compared through its
product L R, which neither changes: the forward (x R^T L^T) and the W
gradient see only that product, and CholeskyQR of L D is Q D for a
diagonal D of signs, so a flip carries through training unchanged.

Tolerances are ``tests/test_torch_wasi_train.py``'s (the reference's own
jit against eager readings there): losses, ``ce`` and ``ppl_proxy``
within 1e-5 relative, grad_norm 1e-4; SGD+momentum params and moments
within 1e-5 of each leaf's scale; AdamW params within 0.3 lr absolute,
moments 1e-3 of their scale; ASI factors within that file's ``ASI_TOL``;
the WSI (L, R) within ``tests/test_torch_vit.py``'s ``WSI_TOL`` (1e-5 of
the scale under SGD, 1e-4 under AdamW); the converted states before
training within 1e-5 of their scale. ``remat="block"`` against
``"none"``, checkpoints and greedy tokens are exact.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as rconfigs
import repro.models.lm as rlm
import repro_torch.configs as tconfigs
import repro_torch.models.lm as tlm
from repro import api as rapi
from repro import serve as rserve
from repro.api import convert as rconvert
from repro.checkpoint import restore_checkpoint as rrestore
from repro.checkpoint import save_checkpoint as rsave
from repro.config import TrainConfig as RTrainConfig
from repro.data.synthetic import SyntheticLM as RSyntheticLM
from repro.train.step import make_train_state as rmake_state
from repro.train.step import make_train_step as rmake_step
from repro_torch import api as tapi
from repro_torch.api import convert as tconvert
from repro_torch.api.bridge import (
    from_reference,
    state_from_reference,
    state_to_reference,
    states_from_reference,
)
from repro_torch.checkpoint import (
    load_manifest,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.config import TrainConfig
from repro_torch.core.project import project_forward_params
from repro_torch.kernels import ops
from repro_torch.serve import ServeEngine
from repro_torch.train.step import (
    make_train_state,
    make_train_step,
    value_and_grad,
)
from repro_torch.utils.memprof import measured_residual_bytes

torch.set_num_threads(1)
KEY = jax.random.PRNGKey(0)
ARCH = "tinyllama-1.1b"
B, S, STEPS = 4, 16, 4
GATES = {"adamw": dict(optimizer="adamw", lr=1e-2, weight_decay=1e-4),
         "sgd_momentum": dict(optimizer="sgd", lr=0.3, momentum=0.9)}
ASI_TOL = {("wasi", "adamw"): 2e-2, ("wasi", "sgd_momentum"): 4e-4}
# tests/test_torch_vit.py's WSI_TOL, but for wasi under AdamW: there the
# reference's own jit and eager runs end with L R 2.6e-4 of its scale
# apart on this gate's inputs (scripts/project_gate_spread.py), and the
# gate holds the port to about 4x that
WSI_TOL = {("wasi", "sgd_momentum"): 1e-5, ("wsi", "sgd_momentum"): 1e-5,
           ("wasi", "adamw"): 1e-3, ("wsi", "adamw"): 1e-4}
PROMPTS = [[3, 1, 4, 1, 5], [9, 2, 6], [7, 7, 7, 7, 2, 1]]


def _cfg(pkg, method, update="project", remat="none"):
    c = pkg.get_smoke(ARCH)
    return c.replace(remat=remat, wasi=dataclasses.replace(
        c.wasi, method=method, update_mode=update))


@functools.cache
def _dense():
    """The reference's dense draws (method ``none``) as numpy."""
    rcfg = _cfg(rconfigs, "none")
    rapi.uninstall(rcfg)
    rapi.install(rapi.resolve(rcfg))
    try:
        return jax.tree.map(np.asarray, rlm.init_lm(KEY, rcfg))
    finally:
        rapi.uninstall(rcfg)


@functools.cache
def _reference_asi(method):
    rcfg = _cfg(rconfigs, method)
    if not rcfg.wasi.compress_acts:
        return None
    return jax.tree.map(np.asarray, rlm.init_lm_states(KEY, rcfg, B, S))


@functools.cache
def _batches():
    data = RSyntheticLM(vocab_size=rconfigs.get_smoke(ARCH).vocab_size,
                        seq_len=S, global_batch=B, seed=1)
    draw = jax.jit(data.batch)
    return [jax.tree.map(np.asarray, draw(i)) for i in range(STEPS)]


def _torch_batch(b):
    return {k: torch.tensor(v).long() for k, v in b.items()}


def _install(method, update="project", remat="none"):
    """Both packages' plans for ``method``, calibrated on the dense draws,
    installed; returns (rcfg, tcfg, rplan, tplan)."""
    rcfg = _cfg(rconfigs, method, update, remat)
    tcfg = _cfg(tconfigs, method, update, remat)
    rapi.uninstall(rcfg)
    tapi.uninstall(tcfg)
    rplan = rapi.install(rapi.resolve(
        rcfg, batch=B, seq=S, calibration=jax.tree.map(jnp.asarray,
                                                       _dense())))
    tplan = tapi.install(tapi.resolve(tcfg, batch=B, seq=S,
                                      calibration=_dense()))
    return rcfg, tcfg, rplan, tplan


def _port_dense():
    return from_reference(_dense(), _cfg(tconfigs, "none"), "cpu")


@functools.cache
def _reference_converted(method):
    """The reference's project-layout conversion of the dense draws under
    its calibrated plan, as numpy."""
    *_, rplan, _ = _install(method)
    return jax.tree.map(np.asarray, rconvert.factorize(
        jax.tree.map(jnp.asarray, _dense()), rplan))


def _port_start(method, tcfg, tplan, ttc, start):
    """The port's ``make_train_state``: ``warm`` on the reference's
    converted tree (the gate's start: both packages from the same
    factors), ``own`` on the port's own conversion of the dense draws,
    ``epsilon`` on the dense draws with ``use_epsilon_ranks`` (a truncated
    SVD at the epsilon ranks)."""
    asi = _reference_asi(method)
    asi = None if asi is None else states_from_reference(asi, "cpu")
    if start == "epsilon":
        return make_train_state(from_reference(_dense(), tcfg, "cpu"), tcfg,
                                ttc, asi_states=asi, use_epsilon_ranks=True)
    tree = (_reference_converted(method) if start == "warm" else
            tconvert.factorize(_port_dense(), tplan))
    return make_train_state(from_reference(tree, tcfg, "cpu"), tcfg, ttc,
                            asi_states=asi)


def _reference_start(method, rcfg, rtc, start):
    """The reference's ``make_train_state`` from its converted tree
    (``warm``; ``own`` alike) or the dense draws (``epsilon``)."""
    asi = _reference_asi(method)
    asi = None if asi is None else jax.tree.map(jnp.asarray, asi)
    if start == "epsilon":
        return rmake_state(KEY, jax.tree.map(jnp.asarray, _dense()), rcfg,
                           rtc, asi_states=asi, use_epsilon_ranks=True)
    return rmake_state(KEY, jax.tree.map(jnp.asarray,
                                         _reference_converted(method)),
                       rcfg, rtc, asi_states=asi)


@functools.cache
def _reference_step(method, gate):
    """One jitted reference step per (method, optimizer), shared by every
    test of this file (the plans, installed alike, do not change the
    traced program)."""
    rcfg, *_ = _install(method)
    rtc = RTrainConfig(steps=STEPS, clip_norm=2.0, checkpoint_every=0,
                       **GATES[gate])
    return jax.jit(rmake_step(rlm.lm_loss, rcfg, rtc))


def _close(got, want, rel, abs_=0.0, msg=""):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(
        np.asarray(got, np.float32), want, rtol=0,
        atol=rel * max(np.abs(want).max(), 1e-30) + abs_, err_msg=msg)


def _wsi_close(got: dict, want: dict, rel):
    """Each path's (L, R) of the same shapes, L R within ``rel`` of its
    scale."""
    assert sorted(got) == sorted(want)
    for path, st in want.items():
        assert got[path].L.shape == st.L.shape, path
        _close(got[path].L @ got[path].R, np.asarray(st.L) @ np.asarray(st.R),
               rel, msg=path)


def _tree_close(got, want, rel, abs_=0.0):
    fg, tg = jax.tree.flatten(got)
    fw, tw = jax.tree.flatten(jax.tree.map(np.asarray, want))
    assert tg == tw
    for g, w in zip(fg, fw):
        _close(g, w, rel, abs_)


# ---------------------------------------------------------------------------
# the train state of a converted checkpoint
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("start", ["warm", "own", "epsilon"])
@pytest.mark.parametrize("method", ["wasi", "wsi"])
def test_make_train_state_matches_reference(method, start):
    """The factors a converted checkpoint carries (the reference's
    conversion, ``warm``, or the port's own, ``own``) strip into warm WSI
    states, and ``use_epsilon_ranks`` on the dense draws (``epsilon``)
    truncates at the epsilon ranks: the reference's paths and ranks, L R
    equal to the reference's (``warm``) or within 1e-5 of its scale (the
    port's own truncated SVD), W bit-equal to the dense draws, the
    model's linears dense again, the moments zero."""
    rcfg, tcfg, rplan, tplan = _install(method)
    kw = dict(GATES["sgd_momentum"], steps=STEPS)
    rstate = _reference_start(method, rcfg, RTrainConfig(**kw), start)
    state = _port_start(method, tcfg, tplan, TrainConfig(**kw), start)
    out = state_to_reference(state)
    _wsi_close(out["wsi"], rstate.wsi, 0.0 if start == "warm" else 1e-5)
    assert all(not m.any() for m in state.opt.mu.values())
    for path, st in state.wsi.items():
        site = path.split("/")[-2]
        assert st.L.shape[-1] == tplan.spec(
            next(s.name for s in tplan.specs
                 if s.name.endswith("/" + site))).rank
    for a, b in zip(jax.tree.leaves(out["params"]),
                    jax.tree.leaves(rstate.params)):
        np.testing.assert_array_equal(a, np.asarray(b))
    up = state.params.groups[0][0]["mlp"]["up"]
    assert sorted(up.keys()) == ["w"]


# ---------------------------------------------------------------------------
# the slice gate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("gate", sorted(GATES))
@pytest.mark.parametrize("method", ["wasi", "wsi"])
def test_project_training_matches_reference(method, gate):
    """4 steps from the same converted checkpoint (the reference's
    conversion, each package's own ``make_train_state``)."""
    rcfg, tcfg, rplan, tplan = _install(method)
    kw = dict(GATES[gate], steps=STEPS, clip_norm=2.0, checkpoint_every=0)
    rstate = _reference_start(method, rcfg, RTrainConfig(**kw), "warm")
    state = _port_start(method, tcfg, tplan, TrainConfig(**kw), "warm")
    rstep = _reference_step(method, gate)
    step = make_train_step(tlm.lm_loss, tcfg, TrainConfig(**kw))
    ops.reset_launches()
    for i, b in enumerate(_batches()):
        rstate, rm = rstep(rstate, jax.tree.map(jnp.asarray, b))
        state, m = step(state, _torch_batch(b))
        for k in ("loss", "grad_norm", "lr", "ce", "ppl_proxy"):
            rtol = 1e-4 if k == "grad_norm" else 1e-5
            np.testing.assert_allclose(float(m[k]), float(rm[k]), rtol=rtol,
                                       err_msg=f"step {i} {k}")
    assert set(ops.launch_counts().values()) == {0}     # CPU: plain
    assert state.step == int(rstate.step) == STEPS
    out = state_to_reference(state)
    _wsi_close(out["wsi"], rstate.wsi, WSI_TOL[method, gate])
    if gate == "adamw":
        _tree_close(out["params"], rstate.params, 0.0,
                    0.3 * GATES[gate]["lr"])
        _tree_close(out["mu"], rstate.opt.mu, 1e-3)
        _tree_close(out["nu"], rstate.opt.nu, 1e-3)
    else:
        _tree_close(out["params"], rstate.params, 1e-5)
        _tree_close(out["mu"], rstate.opt.mu, 1e-5)
    if rstate.asi is not None:
        fg = jax.tree.leaves(out["asi"])
        fw = jax.tree.leaves(rstate.asi)
        assert len(fg) == len(fw) > 0
        for g, w in zip(fg, fw):
            _close(g, w, ASI_TOL[method, gate])


# ---------------------------------------------------------------------------
# remat="block" with the injected factors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["wasi", "wsi"])
def test_project_block_gradients_equal_none(method):
    """One loss on the tree with the factors injected, under ``block`` and
    ``none`` from the same state: loss, every W gradient and the refreshed
    ASI states bit-equal, and the checkpoint keeps the injected L and R
    (the probe counts their stacked storages among its inputs)."""
    out = {}
    for remat in ("none", "block"):
        _, tcfg, _, tplan = _install(method, remat=remat)
        state = _port_start(method, tcfg, tplan, TrainConfig(), "warm")
        fwd = project_forward_params(state.params, state.wsi)
        out[remat] = value_and_grad(tlm.lm_loss, state.params,
                                    _torch_batch(_batches()[0]), tcfg,
                                    state.asi, fwd)
        if remat == "block":
            rep = measured_residual_bytes(
                lambda: tlm.lm_loss(fwd, _torch_batch(_batches()[0]), tcfg,
                                    states=state.asi))
            for st in state.wsi.values():
                for t in (st.L, st.R):
                    assert t.untyped_storage().data_ptr() in rep.storages
    (l0, m0, g0, s0), (l1, m1, g1, s1) = out["none"], out["block"]
    assert torch.equal(l0, l1)
    assert g0.keys() == g1.keys()
    assert all(torch.equal(g0[k], g1[k]) for k in g0)
    if method == "wasi":
        a, b = [], []
        tlm.map_states(a.append, s0)
        tlm.map_states(b.append, s1)
        assert len(a) == len(b) > 0
        assert all(torch.equal(x, y) for x, y in zip(a, b))


# ---------------------------------------------------------------------------
# checkpoints and serving
# ---------------------------------------------------------------------------

def test_project_train_state_checkpoint_crosses_both_ways(tmp_path):
    """A project-mode ``train_state`` (params, moments, ASI states, the WSI
    dict) under a calibrated plan, written by either package, restores in
    the other bit for bit; the manifest says ``calibrated`` and both
    packages read the plan back."""
    rcfg, tcfg, rplan, tplan = _install("wasi")
    kw = dict(GATES["sgd_momentum"], steps=STEPS, clip_norm=2.0,
              checkpoint_every=0)
    rstate = _reference_start("wasi", rcfg, RTrainConfig(**kw), "warm")
    rstate, _ = _reference_step("wasi", "sgd_momentum")(
        rstate, jax.tree.map(jnp.asarray, _batches()[0]))
    rsave(str(tmp_path / "ref"), 1, rstate, plan=rplan, label="train_state")
    template = state_from_reference(jax.tree.map(np.asarray, rstate), tcfg,
                                    "cpu")
    with torch.no_grad():
        for p in template.params.parameters():
            p.zero_()
        for st in template.wsi.values():
            st.L.zero_()
            st.R.zero_()
    got = state_to_reference(restore_checkpoint(str(tmp_path / "ref"), 1,
                                                template))
    for k, st in rstate.wsi.items():
        np.testing.assert_array_equal(got["wsi"][k].L, np.asarray(st.L))
        np.testing.assert_array_equal(got["wsi"][k].R, np.asarray(st.R))
    for a, b in zip(jax.tree.leaves(got["params"]),
                    jax.tree.leaves(rstate.params)):
        np.testing.assert_array_equal(a, np.asarray(b))
    for a, b in zip(jax.tree.leaves(got["asi"]),
                    jax.tree.leaves(rstate.asi)):
        np.testing.assert_array_equal(a, np.asarray(b))
    read = tconvert.load_plan(str(tmp_path / "ref"))
    assert read.calibrated and read.model == tplan.model
    assert [(s.name, s.mode, s.rank) for s in read.specs] == \
        [(s.name, s.mode, s.rank) for s in tplan.specs]
    # port -> reference, after a step of the port's own
    state = _port_start("wasi", tcfg, tplan, TrainConfig(**kw), "warm")
    state, _ = make_train_step(tlm.lm_loss, tcfg, TrainConfig(**kw))(
        state, _torch_batch(_batches()[0]))
    save_checkpoint(str(tmp_path / "port"), 1, state, plan=tplan,
                    label="train_state")
    assert load_manifest(str(tmp_path / "port"), 1)["plan"]["calibrated"]
    assert rconvert.load_plan(str(tmp_path / "port")).calibrated
    want = state_to_reference(state)
    tmpl = _reference_start("wasi", rcfg, RTrainConfig(**kw), "warm")
    tmpl = tmpl._replace(wsi={k: type(tmpl.wsi[k])(
        L=jnp.zeros(v.L.shape), R=jnp.zeros(v.R.shape))
        for k, v in want["wsi"].items()})
    back = rrestore(str(tmp_path / "port"), 1, tmpl)
    for k, st in want["wsi"].items():
        np.testing.assert_array_equal(np.asarray(back.wsi[k].L), st.L)
        np.testing.assert_array_equal(np.asarray(back.wsi[k].R), st.R)
    for a, b in zip(jax.tree.leaves(back.params),
                    jax.tree.leaves(want["params"])):
        np.testing.assert_array_equal(np.asarray(a), b)
    for a, b in zip(jax.tree.leaves(back.asi), jax.tree.leaves(want["asi"])):
        np.testing.assert_array_equal(np.asarray(a), b)


def _drive(engine):
    reqs = [engine.submit(p, max_new=6) for p in PROMPTS]
    engine.run()
    return [r.tokens for r in reqs]


def test_served_calibrated_checkpoint_greedy_tokens_equal_reference(
        tmp_path):
    """The main path's end: two project-mode ``wsi`` steps, the trained
    dense W factorized under the calibrated plan in factored mode (the
    factored config resolved on the same calibration weights: the same
    ranks), saved with that plan; both packages'
    ``ServeEngine.from_checkpoint`` serve it with the same greedy
    tokens, and the port launches no kernel on the CPU."""
    rcfg, tcfg, rplan, tplan = _install("wsi")
    kw = dict(GATES["sgd_momentum"], steps=2, clip_norm=2.0,
              checkpoint_every=0)
    state = _port_start("wsi", tcfg, tplan, TrainConfig(**kw), "warm")
    step = make_train_step(tlm.lm_loss, tcfg, TrainConfig(**kw))
    for b in _batches()[:2]:
        state, _ = step(state, _torch_batch(b))
    fcfg = _cfg(tconfigs, "wsi", "factored")
    tapi.uninstall(fcfg)
    fplan = tapi.resolve(fcfg, calibration=_dense())
    assert [s.rank for s in fplan.specs] == [s.rank for s in tplan.specs]
    assert {s.mode for s in fplan.specs} == {"factored"}
    tree = tconvert.factorize(state.params, fplan)
    save_checkpoint(str(tmp_path), 2, tree, plan=fplan, label="params")
    tapi.uninstall(fcfg)
    ops.reset_launches()
    port = ServeEngine.from_checkpoint(str(tmp_path), device="cpu",
                                       max_slots=2, max_cache=16)
    assert port.plan.calibrated
    ttoks = _drive(port)
    assert set(ops.launch_counts().values()) == {0}
    rfcfg = _cfg(rconfigs, "wsi", "factored")
    rapi.uninstall(rfcfg)
    try:
        ref = rserve.ServeEngine.from_checkpoint(str(tmp_path), max_slots=2,
                                                 max_cache=16)
        assert ref.plan.calibrated
        assert _drive(ref) == ttoks
    finally:
        rapi.uninstall(rfcfg)
        tapi.uninstall(fcfg)
