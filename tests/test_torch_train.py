"""The port's training slice against the reference's, on qwen2 smoke in f32:
``method="wsi"`` (factored sites, no ASI states), parameters from
``repro.models.lm.init_lm`` carried across by ``repro_torch.api.bridge``,
the reference's ``SyntheticLM`` batches handed across as numpy.

The slice gate: 4 steps with a WSI refresh every 2 (two refreshes), under
AdamW and under SGD+momentum; per-step losses, the final params and the
optimizer moments match the reference's ``make_train_step``. Also the
three repairs the training path needed: gradients through the factored
linear on the card's wiring, trainable leaves on the training path, and
per-layer views that are never stale.

Tolerances (f32 on both sides; sums in other orders, a few ulps per op):
losses within 1e-5 relative. Gradients within 1e-4 of each leaf's scale
(the backward through 2 layers, softmax and the tied head). SGD+momentum:
params and moments after 4 steps within 1e-5 of each leaf's scale.
AdamW divides each gradient entry by its own running magnitude, so an
entry at the level of its rounding noise moves its param by up to ~lr in
either package: the reference's own jit and eager runs of this gate end
7.5e-6 relative apart in grad_norm and 8.8e-5 apart on the params
(measured). AdamW is held to 1e-4 relative on grad_norm, 5e-2 lr absolute
on params, and 1e-3 of their scale on the moments.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as rconfigs
import repro.models.lm as rlm
import repro_torch.configs as tconfigs
import repro_torch.models.lm as tlm
from repro.config import TrainConfig as RTrainConfig
from repro.data.synthetic import SyntheticLM as RSyntheticLM
from repro.train.step import make_train_state as rmake_state
from repro.train.step import make_train_step as rmake_step
from repro_torch.api import bind
from repro_torch.api.bridge import (
    from_reference,
    state_from_reference,
    state_to_reference,
    to_reference,
)
from repro_torch.config import TrainConfig
from repro_torch.core.wsi import wsi_refresh_factored
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.kernels import ops
from repro_torch.launch import train as tlaunch
from repro_torch.train.loop import train_loop
from repro_torch.train.step import (
    make_train_state,
    make_train_step,
    value_and_grad,
)

torch.set_num_threads(1)
KEY = jax.random.PRNGKey(0)
B, S, STEPS = 4, 16, 4


def _cfgs(refresh=2):
    def wsi(c):
        return c.replace(wasi=dataclasses.replace(
            c.wasi, method="wsi", refresh_every=refresh))
    return (wsi(rconfigs.get_smoke("qwen2-0.5b")),
            wsi(tconfigs.get_smoke("qwen2-0.5b")))


def _batches(rcfg, n):
    data = RSyntheticLM(vocab_size=rcfg.vocab_size, seq_len=S,
                        global_batch=B, seed=1)
    return [jax.tree.map(np.asarray, data.batch(i)) for i in range(n)]


def _torch_batch(b):
    return {k: torch.from_numpy(v).long() for k, v in b.items()}


def _assert_tree_close(got, want, atol_rel, atol_abs=0.0):
    fg, tg = jax.tree.flatten(got)
    fw, tw = jax.tree.flatten(jax.tree.map(np.asarray, want))
    assert tg == tw
    for g, w in zip(fg, fw):
        np.testing.assert_allclose(
            g, w, rtol=0, atol=atol_rel * max(np.abs(w).max(), 1e-30)
            + atol_abs)


@pytest.fixture(scope="module")
def reference_init():
    rcfg, _ = _cfgs()
    return jax.jit(lambda k: rlm.init_lm(k, rcfg))(KEY)


# ---------------------------------------------------------------------------
# repairs
# ---------------------------------------------------------------------------

def test_grad_through_the_card_wiring_reaches_the_factors(monkeypatch):
    """On the card the forward is a ctypes kernel, whose output carries no
    autograd history. Simulate that here: with the kernels replaced by
    history-free stand-ins (their plain versions under ``no_grad``) and
    the dispatch told the tensors are on a card, the gradient still
    reaches x, R and L, through the sketch and backward wrappers."""
    calls = []

    def fake_fused(x, r, l_, *, save_sketch=False):
        calls.append("fwd_sketch" if save_sketch else "fwd")
        with torch.no_grad():
            y, h = ops.ref.lowrank_sketch_ref(x, r, l_)
        return (y, h) if save_sketch else y

    def fake_bwd(dy, x, h, l_, r):
        calls.append("bwd")
        return ops.ref.lowrank_bwd_ref(dy, x, h, l_, r)

    monkeypatch.setattr(ops, "_on_cpu", lambda t: False)
    monkeypatch.setattr(ops, "lowrank_fused", fake_fused)
    monkeypatch.setattr(ops, "lowrank_bwd", fake_bwd)
    rng = np.random.default_rng(0)
    x, r, l_ = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                .requires_grad_(True) for s in ((3, 5, 16), (4, 16), (8, 4)))
    ops.lowrank_matmul(x, r, l_).sum().backward()
    assert calls == ["fwd_sketch", "bwd"]
    for t in (x, r, l_):
        assert t.grad is not None and torch.isfinite(t.grad).all()
    want_r = (torch.ones(15, 8) @ l_.detach()).T @ x.detach().reshape(15, 16)
    torch.testing.assert_close(r.grad, want_r, rtol=1e-5, atol=1e-5)


def test_serving_leaves_frozen_training_leaves_trainable(reference_init):
    rcfg, tcfg = _cfgs()
    model = tlm.init_lm(tcfg, device="cpu")
    assert not any(p.requires_grad for p in model.parameters())
    assert not any(p.requires_grad for p in
                   from_reference(jax.tree.map(np.asarray, reference_init),
                                  tcfg, "cpu").parameters())
    make_train_state(model, tcfg, TrainConfig(steps=1))
    assert all(p.requires_grad for p in model.parameters())


def test_layer_views_are_never_stale():
    """Views cached by a no-grad forward (serving) must not be reused once
    the leaves are trainable and grad is on, and an in-place update of the
    leaves (optimizer, refresh) shows through the cached views."""
    _, tcfg = _cfgs()
    model = tlm.init_lm(tcfg, device="cpu", seed=3)
    toks = torch.randint(0, tcfg.vocab_size, (2, 6),
                         generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        before, *_ = tlm.lm_forward(model, toks, tcfg)
    model.requires_grad_(True)
    logits, *_ = tlm.lm_forward(model, toks, tcfg)
    leaves = list(model.groups.parameters())
    grads = torch.autograd.grad(logits.square().sum(), leaves,
                                allow_unused=True)
    assert all(g is not None and torch.isfinite(g).all() for g in grads)
    with torch.no_grad():
        for p in leaves:
            p.mul_(0.5)
        after, *_ = tlm.lm_forward(model, toks, tcfg)
    assert not torch.allclose(before, after)
    model.requires_grad_(False)
    with torch.no_grad():
        again, *_ = tlm.lm_forward(model, toks, tcfg)
    torch.testing.assert_close(again, after, rtol=0, atol=0)


def test_one_step_gradients_match_reference(reference_init):
    """After one forward/backward every trainable leaf has a finite
    gradient, equal to ``jax.grad`` of the reference's ``lm_loss``."""
    rcfg, tcfg = _cfgs()
    batch = _batches(rcfg, 1)[0]
    tree = jax.tree.map(np.asarray, reference_init)
    model = from_reference(tree, tcfg, "cpu")
    make_train_state(model, tcfg, TrainConfig(steps=1))
    loss, metrics, grads, _ = value_and_grad(tlm.lm_loss, model,
                                          _torch_batch(batch), tcfg)
    (wloss, (_, wmet)), wgrads = jax.jit(jax.value_and_grad(
        lambda p: rlm.lm_loss(p, jax.tree.map(jnp.asarray, batch), rcfg),
        has_aux=True))(reference_init)
    np.testing.assert_allclose(float(loss), float(wloss), rtol=1e-5)
    for k in ("ce", "aux", "ppl_proxy"):
        np.testing.assert_allclose(float(metrics[k]), float(wmet[k]),
                                   rtol=1e-5, atol=1e-7)
    assert set(grads) == {n for n, _ in model.named_parameters()}
    assert all(torch.isfinite(g).all() for g in grads.values())
    got = {n: g.numpy() for n, g in grads.items()}
    flat = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}.{k}" if prefix else k)
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, f"{prefix}.{i}" if prefix else str(i))
        else:
            flat[prefix] = np.asarray(node)
    walk(wgrads, "")
    assert set(flat) == set(got)
    for n in got:
        np.testing.assert_allclose(got[n], flat[n], rtol=0,
                                   atol=1e-4 * np.abs(flat[n]).max())


# ---------------------------------------------------------------------------
# the slice gate
# ---------------------------------------------------------------------------

GATES = {"adamw": dict(optimizer="adamw", lr=1e-2, weight_decay=1e-4),
         "sgd_momentum": dict(optimizer="sgd", lr=0.3, momentum=0.9)}


@pytest.mark.parametrize("gate", sorted(GATES))
def test_wsi_training_matches_reference_train_step(gate, reference_init):
    rcfg, tcfg = _cfgs(refresh=2)
    kw = dict(GATES[gate], steps=STEPS, clip_norm=2.0, checkpoint_every=0)
    rtc, ttc = RTrainConfig(**kw), TrainConfig(**kw)
    rstate = rmake_state(KEY, reference_init, rcfg, rtc)
    state = state_from_reference(jax.tree.map(np.asarray, rstate), tcfg,
                                 "cpu")
    rstep = jax.jit(rmake_step(rlm.lm_loss, rcfg, rtc))
    step = make_train_step(tlm.lm_loss, tcfg, ttc)
    for i, batch in enumerate(_batches(rcfg, STEPS)):
        rstate, rm = rstep(rstate, jax.tree.map(jnp.asarray, batch))
        state, m = step(state, _torch_batch(batch))
        for k in ("loss", "grad_norm", "lr", "ce"):
            rtol = 1e-4 if (gate, k) == ("adamw", "grad_norm") else 1e-5
            np.testing.assert_allclose(float(m[k]), float(rm[k]), rtol=rtol,
                                       err_msg=f"step {i} {k}")
    assert state.step == int(rstate.step) == STEPS
    out = state_to_reference(state)
    assert out["opt_step"] == int(rstate.opt.step)
    if gate == "adamw":
        _assert_tree_close(out["params"], rstate.params, 0.0,
                           5e-2 * GATES[gate]["lr"])
        _assert_tree_close(out["mu"], rstate.opt.mu, 1e-3)
        _assert_tree_close(out["nu"], rstate.opt.nu, 1e-3)
    else:
        _assert_tree_close(out["params"], rstate.params, 1e-5)
        _assert_tree_close(out["mu"], rstate.opt.mu, 1e-5)
        assert out["nu"] is None and rstate.opt.nu is None


def test_microbatch_accumulation_matches_reference(reference_init):
    """Two microbatches of the batch, f32 gradient accumulation; one
    step, then the params."""
    rcfg, tcfg = _cfgs(refresh=0)
    kw = dict(optimizer="sgd", lr=0.3, momentum=0.9, steps=2, microbatch=2,
              checkpoint_every=0)
    rtc, ttc = RTrainConfig(**kw), TrainConfig(**kw)
    rstate = rmake_state(KEY, reference_init, rcfg, rtc)
    state = state_from_reference(jax.tree.map(np.asarray, rstate), tcfg,
                                 "cpu")
    batch = _batches(rcfg, 1)[0]
    rstate, rm = jax.jit(rmake_step(rlm.lm_loss, rcfg, rtc))(
        rstate, jax.tree.map(jnp.asarray, batch))
    state, m = make_train_step(tlm.lm_loss, tcfg, ttc)(state,
                                                       _torch_batch(batch))
    np.testing.assert_allclose(float(m["loss"]), float(rm["loss"]),
                               rtol=1e-5)
    _assert_tree_close(state_to_reference(state)["params"], rstate.params,
                       1e-5)


def test_refresh_runs_in_place_on_the_stacked_leaves():
    """``map_factored`` keeps every leaf's storage and preserves each
    layer's L R; L comes out orthonormal per layer."""
    _, tcfg = _cfgs()
    model = tlm.init_lm(tcfg, device="cpu", seed=4)
    pairs = [(p["L"], p["R"]) for _, p in bind.iter_linear_dicts(model.tree())
             if "L" in p]
    assert len(pairs) == 7
    ptrs = [(lf.data_ptr(), rf.data_ptr()) for lf, rf in pairs]
    prods = [(lf @ rf).clone() for lf, rf in pairs]
    bind.map_factored(model.tree(), wsi_refresh_factored)
    assert [(lf.data_ptr(), rf.data_ptr()) for lf, rf in pairs] == ptrs
    for (lf, rf), want in zip(pairs, prods):
        torch.testing.assert_close(lf @ rf, want, rtol=1e-4, atol=1e-5)
        eye = torch.eye(lf.shape[-1]).expand(lf.shape[0], -1, -1)
        torch.testing.assert_close(lf.mT @ lf, eye, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# loop, data and launcher
# ---------------------------------------------------------------------------

def test_synthetic_lm_is_a_deterministic_shifted_stream():
    data = SyntheticLM(vocab_size=64, seq_len=12, global_batch=3, seed=5)
    a, b = data.batch(7), data.batch(7)
    assert torch.equal(a["tokens"], b["tokens"])
    assert not torch.equal(a["labels"], data.batch(8)["labels"])
    assert a["tokens"].shape == a["labels"].shape == (3, 12)
    assert torch.equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    assert 0 <= int(a["labels"].min()) and int(a["labels"].max()) < 64
    skew = data.for_tenant("u1").batch(0, batch_size=5)
    assert skew["tokens"].shape == (5, 12)


def test_launcher_trains_on_the_cpu_and_refuses_a_silent_fallback(
        monkeypatch, capsys):
    hist = tlaunch.main(["--device", "cpu", "--arch", "qwen2-0.5b",
                         "--wasi", "wsi", "--steps", "2", "--batch", "2",
                         "--seq", "8"])
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)
    assert "wasi=wsi" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlaunch.main(["--arch", "qwen2-0.5b", "--wasi", "wsi",
                      "--steps", "1"])


def test_unported_training_modes_raise():
    """Project mode for decoder LMs is ported: from the same dense weights
    the port's train state holds the reference's WSI states, the same
    paths and static ranks, each L R a best rank-K approximation of its W
    as the reference's is (||W - L R|| / ||W|| equal within 1e-5; a random
    W cut at half its rank has near-equal singular values at the cut,
    where two LAPACK builds pick other subspaces of the same error).
    PowerSGD, the mesh step and ``batch_sharding`` still raise."""
    rcfg, tcfg = _cfgs()
    rproj, tproj = (c.replace(wasi=dataclasses.replace(
        c.wasi, update_mode="project")) for c in (rcfg, tcfg))
    dense = tlm.init_lm(tproj, device="cpu")
    rstate = rmake_state(KEY, jax.tree.map(jnp.asarray, to_reference(dense)),
                         rproj, RTrainConfig())
    pstate = make_train_state(dense, tproj, TrainConfig())
    assert sorted(pstate.wsi) == sorted(rstate.wsi)
    flat = dict(jax.tree_util.tree_flatten_with_path(rstate.params)[0])
    for k, st in rstate.wsi.items():
        assert pstate.wsi[k].L.shape == st.L.shape, k
        w = np.asarray(next(v for p, v in flat.items()
                            if "/".join(str(getattr(e, "key", getattr(
                                e, "idx", e))) for e in p) == k))

        def residual(lr):
            return np.linalg.norm(w - lr, axis=(-2, -1)) / np.linalg.norm(
                w, axis=(-2, -1))
        np.testing.assert_allclose(
            residual((pstate.wsi[k].L @ pstate.wsi[k].R).detach().numpy()),
            residual(np.asarray(st.L @ st.R)), rtol=0, atol=1e-5,
            err_msg=k)
    model = tlm.init_lm(tcfg, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_train_state(model, tcfg, TrainConfig(powersgd_rank=2))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_train_step(tlm.lm_loss, tcfg, TrainConfig(), mesh=object())
    state = make_train_state(model, tcfg, TrainConfig(steps=1))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        train_loop(state, lambda s, b: (s, {}), lambda s: {}, TrainConfig(),
                   batch_sharding=object())


def test_train_loop_logs_every_step_it_is_asked_to():
    rcfg, tcfg = _cfgs()
    model = from_reference(to_reference(tlm.init_lm(tcfg, device="cpu")),
                           tcfg, "cpu")
    ttc = TrainConfig(optimizer="adamw", lr=1e-3, steps=3)
    state = make_train_state(model, tcfg, ttc)
    data = SyntheticLM(vocab_size=tcfg.vocab_size, seq_len=8, global_batch=2)
    ops.reset_launches()
    state, hist = train_loop(state, make_train_step(tlm.lm_loss, tcfg, ttc),
                             data.batch, ttc, log_every=1, log_fn=lambda s: 0)
    assert [h["step"] for h in hist] == [0, 1, 2] and state.step == 3
    assert all(h["sec"] > 0 and np.isfinite(h["loss"]) for h in hist)
    assert set(ops.launch_counts().values()) == {0}     # CPU: plain versions
