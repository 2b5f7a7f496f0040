"""The port's ViT (the paper's primary model) against the reference's, on
vit-smoke in f32: ``vit_forward`` logits and ASI states, the slice gate
(4 training steps of ``make_train_step(vit_loss)`` from params, ASI
states and WSI states carried across by ``api.bridge``, on the
reference's ``SyntheticVision`` batches handed across as numpy), the
bytes ``vit_loss`` saves for backward, and project-mode checkpoints both
ways.

The gate runs project mode (``update_mode="project"``) as the paper
does: ``wasi`` (Tucker residuals, gradient on the full W) and ``wsi``
(exact gradient) with ``use_epsilon_ranks=True``, beside ``asi`` and
``none``; vit-smoke's own scope, ``all``.

Tolerances (f32 on both sides, sums in other orders; the reference's own
jit and eager runs of the same 4 steps, measured on these inputs, in
parentheses):

* losses and ``ce`` within 1e-5 relative (read: <= 1.2e-6), grad_norm
  1e-4.
* SGD+momentum: params and the WSI (L, R) within 1e-5 of each leaf's
  scale (read: <= 1.4e-6; reference 1.3e-6), PR 14's SGD bound; ASI
  factors 1e-4 of their scale (read: <= 5.6e-5 with microbatches, 1.3e-5
  without; reference 2.1e-5 and 6.0e-6): each step's subspace iteration
  starts from the last step's factors, so rounding turns the subspaces a
  little (PR 14, ROADMAP.md queue 3).
* AdamW divides each gradient entry by its own running magnitude, so an
  entry at the level of its rounding noise moves its param by up to ~lr
  in either package (PR 14): params within 0.3 lr absolute, moments 1e-3
  of their scale; these params feed the next step's activations, so the
  WSI (L, R) are held to 1e-4 of their scale (read: 1.2e-5; reference
  5.3e-6) and the ASI factors to 4e-4 (read: 1.05e-4 under asi;
  reference 1.6e-5).
* Residual bytes are counts: per-method differences equal, no tolerance.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as rconfigs
import repro.models.vit as rvit
import repro.utils.memprof as rmem
import repro_torch.configs as tconfigs
import repro_torch.models.vit as tvit
import repro_torch.utils.memprof as tmem
from repro import api as rapi
from repro.checkpoint import restore_checkpoint as rrestore
from repro.checkpoint import save_checkpoint as rsave
from repro.config import TrainConfig as RTrainConfig
from repro.core.project import project_forward_params as rproject_fwd
from repro.data.synthetic import SyntheticVision as RSyntheticVision
from repro.train.step import make_train_state as rmake_state
from repro.train.step import make_train_step as rmake_step
from repro_torch import api as tapi
from repro_torch.api.bridge import (
    from_reference,
    state_from_reference,
    state_to_reference,
    states_from_reference,
    to_reference,
)
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.config import TrainConfig
from repro_torch.core.project import project_forward_params
from repro_torch.data.synthetic import SyntheticVision
from repro_torch.kernels import ops
from repro_torch.train.loop import train_loop
from repro_torch.train.step import make_train_state, make_train_step

torch.set_num_threads(1)
KEY = jax.random.PRNGKey(0)
B, NP, PD, NC, STEPS = 8, 16, 24, 4, 4


def _cfgs(method, update="project"):
    def m(c):
        return c.replace(wasi=dataclasses.replace(c.wasi, method=method,
                                                  update_mode=update))
    return (m(rconfigs.get_smoke("vit-base")),
            m(tconfigs.get_smoke("vit-base")))


def _install(rcfg, tcfg, batch=B):
    rapi.uninstall(rcfg)
    tapi.uninstall(tcfg)
    rapi.install(rapi.resolve(rcfg, batch=batch, seq=NP + 1))
    tapi.install(tapi.resolve(tcfg, batch=batch, seq=NP + 1))


def _batches(n, batch=B):
    data = RSyntheticVision(n_classes=NC, n_patches=NP, patch_dim=PD,
                            global_batch=batch, seed=0, noise=0.5)
    return [jax.tree.map(np.asarray, data.batch(i)) for i in range(n)]


def _torch_batch(b):
    return {"patches": torch.tensor(b["patches"]),
            "labels": torch.tensor(b["labels"]).long()}


def _tree_close(got, want, rel, abs_=0.0):
    fg, tg = jax.tree.flatten(got)
    fw, tw = jax.tree.flatten(jax.tree.map(np.asarray, want))
    assert tg == tw
    for g, w in zip(fg, fw):
        np.testing.assert_allclose(
            np.asarray(g, np.float32), w, rtol=0,
            atol=rel * max(np.abs(w).max(), 1e-30) + abs_)


def _asi_leaves(node):
    """Leaves of the port's ASI states as numpy, in JAX's flatten order
    (dicts by sorted key, None an empty subtree)."""
    if node is None:
        return []
    if isinstance(node, dict):
        return [x for k in sorted(node) for x in _asi_leaves(node[k])]
    if isinstance(node, (list, tuple)):
        return [x for v in node for x in _asi_leaves(v)]
    return [node.detach().numpy()]


# ---------------------------------------------------------------------------
# the forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["wasi", "none"])
def test_vit_forward_matches_reference(method):
    """Logits without states (inference) and with ASI states (the train
    forward, project mode's factors injected), from bridged params: 1e-5
    of their scale. The refreshed ASI factors: 1e-4 of their scale (read:
    1.9e-5); one subspace iteration magnifies the activations' rounding
    differences by the inverse gap between kept and dropped singular
    values, small at smoke ranks."""
    rcfg, tcfg = _cfgs(method)
    _install(rcfg, tcfg)
    params = rvit.init_vit(KEY, rcfg, NC, PD, NP)
    model = from_reference(jax.tree.map(np.asarray, params), tcfg, "cpu")
    assert isinstance(model, tvit.VisionTransformer)
    patches = _batches(1)[0]["patches"]
    want, _ = rvit.vit_forward(params, jnp.asarray(patches), rcfg)
    ops.reset_launches()
    got, none = tvit.vit_forward(model, torch.tensor(patches), tcfg)
    assert none is None and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5 * np.abs(want).max())
    assert set(ops.launch_counts().values()) == {0}    # CPU: plain versions
    if not rcfg.wasi.compress_acts:
        return
    st = rvit.init_vit_states(KEY, rcfg, B, NP)
    rstate = rmake_state(KEY, params, rcfg, RTrainConfig(), asi_states=st,
                         use_epsilon_ranks=True)
    state = state_from_reference(jax.tree.map(np.asarray, rstate), tcfg,
                                 "cpu")
    want, wst = jax.jit(lambda p, x, s: rvit.vit_forward(
        rproject_fwd(p, rstate.wsi), x, rcfg, states=s))(
            params, jnp.asarray(patches), st)
    with torch.no_grad():
        got, gst = tvit.vit_forward(
            project_forward_params(state.params, state.wsi),
            torch.tensor(patches), tcfg, states=state.asi)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5 * np.abs(want).max())
    for a, w in zip(_asi_leaves(gst), jax.tree.leaves(wst)):
        w = np.asarray(w)
        np.testing.assert_allclose(a, w, rtol=0,
                                   atol=1e-4 * np.abs(w).max())


def test_vit_trees_and_states_cross_the_bridge():
    """``init_vit``/``init_vit_states`` of both packages: one tree, one
    set of shapes, ASI states stacked on the layer dim; the round trip
    through the bridge is exact."""
    rcfg, tcfg = _cfgs("wasi")
    _install(rcfg, tcfg)
    params = rvit.init_vit(KEY, rcfg, NC, PD, NP)
    model = tvit.init_vit(tcfg, NC, PD, NP, device="cpu", seed=1)
    shapes = jax.tree.map(lambda x: tuple(x.shape), params)
    assert jax.tree.map(lambda x: tuple(x.shape), to_reference(model)) \
        == shapes
    back = to_reference(from_reference(jax.tree.map(np.asarray, params),
                                       tcfg, "cpu"))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, np.asarray(b))
    rst = rvit.init_vit_states(KEY, rcfg, B, NP)
    tst = tvit.init_vit_states(tcfg, B, NP, device="cpu")
    assert [x.shape for x in _asi_leaves(tst)] == \
        [tuple(x.shape) for x in jax.tree.leaves(rst)]
    carried = states_from_reference(jax.tree.map(np.asarray, rst), "cpu")
    for a, b in zip(_asi_leaves(carried), jax.tree.leaves(rst)):
        np.testing.assert_array_equal(a, np.asarray(b))


# ---------------------------------------------------------------------------
# the slice gate
# ---------------------------------------------------------------------------

GATES = {"adamw": dict(optimizer="adamw", lr=1e-2, weight_decay=1e-4),
         "sgd_momentum": dict(optimizer="sgd", lr=0.05, momentum=0.9)}
ASI_TOL = {"sgd_momentum": 1e-4, "adamw": 4e-4}
WSI_TOL = {"sgd_momentum": 1e-5, "adamw": 1e-4}


def _gate(method, gate, *, microbatch=1):
    rcfg, tcfg = _cfgs(method)
    _install(rcfg, tcfg, B // microbatch)
    kw = dict(GATES[gate], steps=STEPS, clip_norm=2.0, checkpoint_every=0,
              microbatch=microbatch)
    rtc, ttc = RTrainConfig(**kw), TrainConfig(**kw)
    params = rvit.init_vit(KEY, rcfg, NC, PD, NP)
    st = rvit.init_vit_states(KEY, rcfg, B // microbatch, NP) \
        if rcfg.wasi.compress_acts else None
    rstate = rmake_state(KEY, params, rcfg, rtc, asi_states=st,
                         use_epsilon_ranks=True)
    assert (rstate.wsi is not None) == rcfg.wasi.project
    state = state_from_reference(jax.tree.map(np.asarray, rstate), tcfg,
                                 "cpu")
    rstep = jax.jit(rmake_step(rvit.vit_loss, rcfg, rtc))
    step = make_train_step(tvit.vit_loss, tcfg, ttc)
    for i, b in enumerate(_batches(STEPS)):
        rstate, rm = rstep(rstate, jax.tree.map(jnp.asarray, b))
        state, m = step(state, _torch_batch(b))
        for k in ("loss", "grad_norm", "lr", "ce", "acc"):
            rtol = 1e-4 if k == "grad_norm" else 1e-5
            np.testing.assert_allclose(float(m[k]), float(rm[k]), rtol=rtol,
                                       err_msg=f"step {i} {k}")
    assert state.step == int(rstate.step) == STEPS
    out = state_to_reference(state)
    if gate == "adamw":
        _tree_close(out["params"], rstate.params, 0.0,
                    0.3 * GATES[gate]["lr"])
        _tree_close(out["mu"], rstate.opt.mu, 1e-3)
        _tree_close(out["nu"], rstate.opt.nu, 1e-3)
    else:
        _tree_close(out["params"], rstate.params, 1e-5)
        _tree_close(out["mu"], rstate.opt.mu, 1e-5)
    if rstate.wsi is not None:
        assert sorted(out["wsi"]) == sorted(rstate.wsi)
        _tree_close({k: tuple(v) for k, v in out["wsi"].items()},
                    {k: tuple(v) for k, v in rstate.wsi.items()},
                    WSI_TOL[gate])
    if rstate.asi is not None:
        for a, w in zip(_asi_leaves(state.asi), jax.tree.leaves(rstate.asi)):
            w = np.asarray(w)
            np.testing.assert_allclose(a, w, rtol=0, atol=ASI_TOL[gate]
                                       * np.abs(w).max())
    return rstate, state


@pytest.mark.parametrize("method,gate", [
    ("wasi", "sgd_momentum"), ("wasi", "adamw"), ("asi", "sgd_momentum"),
    ("asi", "adamw"), ("none", "sgd_momentum"), ("wsi", "sgd_momentum")])
def test_vit_training_matches_reference_train_step(method, gate):
    _gate(method, gate)


def test_vit_project_mode_with_microbatches_matches_reference():
    """Batch 8 in two slices of 4: the injected factors serve both slices,
    the ASI states carry from one to the next, the f32 gradients are
    averaged, then one WSI step."""
    _gate("wasi", "sgd_momentum", microbatch=2)


# ---------------------------------------------------------------------------
# saved-for-backward bytes, checkpoints, the loop
# ---------------------------------------------------------------------------

def _vit_residual_bytes(method):
    rcfg, tcfg = _cfgs(method)
    _install(rcfg, tcfg)
    params = rvit.init_vit(KEY, rcfg, NC, PD, NP)
    st = rvit.init_vit_states(KEY, rcfg, B, NP) if rcfg.wasi.compress_acts \
        else None
    rstate = rmake_state(KEY, params, rcfg, RTrainConfig(), asi_states=st,
                         use_epsilon_ranks=True)
    fwd = params if rstate.wsi is None else rproject_fwd(params, rstate.wsi)
    b = _batches(1)[0]
    want = rmem.measured_residual_bytes(
        lambda p: rvit.vit_loss(p, jax.tree.map(jnp.asarray, b), rcfg,
                                states=st), fwd, has_aux=True).total_bytes
    state = state_from_reference(jax.tree.map(np.asarray, rstate), tcfg,
                                 "cpu")
    tfwd = state.params if state.wsi is None else project_forward_params(
        state.params, state.wsi)
    got = tmem.measured_residual_bytes(
        lambda: tvit.vit_loss(tfwd, _torch_batch(b), tcfg,
                              states=state.asi)).total_bytes
    return got, want


def test_vit_loss_residual_bytes_move_with_the_method_as_the_reference():
    """One smoke ``vit_loss`` under each method: what each method adds or
    removes against ``none`` is equal to the byte in both packages; the
    rest of the model (attention, the norms, GELU, the loss) saves other
    intermediates in each framework, a constant offset (ROADMAP.md
    queue 3)."""
    out = {m: _vit_residual_bytes(m) for m in ("none", "asi", "wsi", "wasi")}
    offsets = {m: w - g for m, (g, w) in out.items()}
    assert len(set(offsets.values())) == 1, offsets
    for m, (g, w) in out.items():
        assert g - out["none"][0] == w - out["none"][1], m


def test_project_checkpoint_crosses_both_ways(tmp_path):
    """A project-mode ``train_state`` (params, moments, ASI states and the
    WSI dict) written by either package restores in the other: W, L and R
    equal bit for bit, in the reference's flatten order."""
    rcfg, tcfg = _cfgs("wasi")
    _install(rcfg, tcfg)
    rtc = RTrainConfig(optimizer="sgd", lr=0.05, momentum=0.9, steps=1)
    ttc = TrainConfig(optimizer="sgd", lr=0.05, momentum=0.9, steps=1)
    params = rvit.init_vit(KEY, rcfg, NC, PD, NP)
    rstate = rmake_state(KEY, params, rcfg, rtc,
                         asi_states=rvit.init_vit_states(KEY, rcfg, B, NP),
                         use_epsilon_ranks=True)
    rstate, _ = jax.jit(rmake_step(rvit.vit_loss, rcfg, rtc))(
        rstate, jax.tree.map(jnp.asarray, _batches(1)[0]))
    # reference -> port
    rsave(str(tmp_path / "ref"), 1, rstate)
    template = state_from_reference(jax.tree.map(np.asarray, rstate), tcfg,
                                    "cpu")
    from repro_torch.core.wsi import WSIState
    template = template._replace(wsi={k: WSIState(torch.zeros_like(v.L),
                                                  torch.zeros_like(v.R))
                                      for k, v in template.wsi.items()})
    with torch.no_grad():
        for p in template.params.parameters():
            p.zero_()
    got = restore_checkpoint(str(tmp_path / "ref"), 1, template)
    out = state_to_reference(got)
    for k, st in rstate.wsi.items():
        np.testing.assert_array_equal(out["wsi"][k].L, np.asarray(st.L))
        np.testing.assert_array_equal(out["wsi"][k].R, np.asarray(st.R))
    for a, b in zip(jax.tree.leaves(out["params"]),
                    jax.tree.leaves(rstate.params)):
        np.testing.assert_array_equal(a, np.asarray(b))
    # port -> reference, after a step of the port's own
    model = tvit.init_vit(tcfg, NC, PD, NP, device="cpu", seed=4)
    state = make_train_state(model, tcfg, ttc,
                             asi_states=tvit.init_vit_states(
                                 tcfg, B, NP, device="cpu", seed=4),
                             use_epsilon_ranks=True)
    state, _ = make_train_step(tvit.vit_loss, tcfg, ttc)(
        state, _torch_batch(_batches(1)[0]))
    save_checkpoint(str(tmp_path / "port"), 1, state)
    tmpl = rmake_state(KEY, rvit.init_vit(KEY, rcfg, NC, PD, NP), rcfg, rtc,
                       asi_states=rvit.init_vit_states(KEY, rcfg, B, NP),
                       use_epsilon_ranks=True)
    want = state_to_reference(state)
    if {k: v.L.shape for k, v in tmpl.wsi.items()} != \
            {k: v.L.shape for k, v in want["wsi"].items()}:
        # the port's ranks come from its own random init: a template of
        # the port's shapes
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


def test_train_loop_runs_the_vit_path_on_the_cpu():
    """``train_loop`` over ``vit_loss`` in project mode with the port's
    own ``SyntheticVision`` and memprof: finite losses, the loss falls,
    no kernel launches on the CPU, and the trained model infers."""
    _, tcfg = _cfgs("wasi")
    tapi.uninstall(tcfg)
    tapi.install(tapi.resolve(tcfg, batch=B, seq=NP + 1))
    ttc = TrainConfig(optimizer="sgd", lr=0.05, momentum=0.9, steps=12,
                      clip_norm=2.0, checkpoint_every=0)
    model = tvit.init_vit(tcfg, NC, PD, NP, device="cpu", seed=233)
    state = make_train_state(model, tcfg, ttc, asi_states=tvit.init_vit_states(
        tcfg, B, NP, device="cpu", seed=233), use_epsilon_ranks=True)
    data = SyntheticVision(n_classes=NC, n_patches=NP, patch_dim=PD,
                           global_batch=B, seed=0, noise=0.5)
    ops.reset_launches()
    state, hist = train_loop(state, make_train_step(tvit.vit_loss, tcfg, ttc),
                             data.batch, ttc, log_every=1, memprof=True,
                             log_fn=lambda s: 0)
    losses = [h["loss"] for h in hist]
    assert len(hist) == 12 and np.isfinite(losses).all()
    assert np.mean(losses[-3:]) < np.mean(losses[:3])
    assert all(h["mem_live_mib"] > 0 for h in hist)
    assert set(ops.launch_counts().values()) == {0}
    b = data.batch(99)
    with torch.no_grad():
        logits, _ = tvit.vit_forward(model, b["patches"], tcfg)
    assert logits.shape == (B, NC) and torch.isfinite(logits).all()


@pytest.mark.parametrize("full", [True, False])
def test_vit_plan_matches_reference(full):
    """``api.resolve`` of vit-base (the paper's project-mode WASI, MLP
    scope) and vit-smoke at the ViT's 197 and 17 tokens: the reference's
    sites (attention and the GELU MLP, no gate), modes, ranks and ASI
    ranks, JSON equal but for ``bwd_fits_vmem``, the TPU fit rule the port
    leaves None (api/plan.py)."""
    get_r = rconfigs.get if full else rconfigs.get_smoke
    get_t = tconfigs.get if full else tconfigs.get_smoke
    rcfg, tcfg = get_r("vit-base"), get_t("vit-base")
    seq = 197 if full else NP + 1
    rplan = rapi.resolve(rcfg, batch=B, seq=seq)
    tplan = tapi.resolve(tcfg, batch=B, seq=seq)
    tj, rj = tplan.to_json(), rplan.to_json()
    assert all(sp.pop("bwd_fits_vmem") is None for sp in tj["specs"])
    for sp in rj["specs"]:
        sp.pop("bwd_fits_vmem")
    assert tj == rj
    assert {s.name for s in tplan.specs} == {
        "attn/wq", "attn/wk", "attn/wv", "attn/wo", "mlp/up", "mlp/down"}
    if full:
        assert {s.name: s.mode for s in tplan.specs if s.role == "mlp"} == \
            {"mlp/up": "project", "mlp/down": "project"}
