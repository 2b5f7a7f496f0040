"""The port's checkpoints against the reference's on-disk layout, both
ways: a directory written by either package restores in the other (leaves
equal bit for bit, manifests equal), bf16 leaves are byte-identical
``.npy`` files, and the checkpoint mechanics of
``tests/test_checkpoint.py`` (stale ``.tmp`` dirs, retention, restart,
multi-process merge) hold for the port. Also the training loop's restart:
a run stopped at step 3 and resumed ends where an uninterrupted run ends.
"""
import dataclasses
import json
import os

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
from repro.api import convert as rconvert
from repro.checkpoint import restore_checkpoint as rrestore
from repro.checkpoint import restore_extra as rrestore_extra
from repro.checkpoint import restore_untyped as rrestore_untyped
from repro.checkpoint import save_checkpoint as rsave
from repro.config import TrainConfig as RTrainConfig
from repro.train.step import make_train_state as rmake_state
from repro_torch import api as tapi
from repro_torch.api import convert as tconvert
from repro_torch.api.bridge import state_from_reference
from repro_torch.api.plan import SubspacePlan as TPlan
from repro_torch.checkpoint import (
    CheckpointManager,
    latest_step,
    load_manifest,
    restore_checkpoint,
    restore_extra,
    restore_untyped,
    save_checkpoint,
    sweep_stale_tmp,
)
from repro_torch.config import TrainConfig
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.launch import serve as tlaunch_serve
from repro_torch.launch import train as tlaunch_train
from repro_torch.train.loop import train_loop
from repro_torch.train.step import make_train_state, make_train_step

torch.set_num_threads(1)
SMOKE = "qwen2-0.5b"


def _flat(tree):
    """Leaves of a nested dict/list/tuple in JAX's flatten order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _flat(v)]
    return [] if tree is None else [tree]


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(x)


def _assert_leaves_equal(got, want):
    g, w = _flat(got), _flat(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        a, b = _np(a), np.asarray(b)
        assert a.shape == b.shape and str(a.dtype) == str(b.dtype)
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def ref_state():
    """A reference TrainState of qwen2 smoke under ``wsi`` and AdamW with
    non-zero moments and step counts, its plan, and an extra tree."""
    cfg = rconfigs.get_smoke(SMOKE)
    cfg = cfg.replace(wasi=dataclasses.replace(cfg.wasi, method="wsi"))
    key = jax.random.PRNGKey(0)
    params = rlm.init_lm(key, cfg, jnp.float32)
    st = rmake_state(key, params, cfg, RTrainConfig(optimizer="adamw"))
    fill = lambda t, c: jax.tree.map(lambda x: jnp.full_like(x, c) *
                                     jnp.arange(x.size).reshape(x.shape)
                                     / x.size, t)
    st = st._replace(opt=st.opt._replace(
        step=jnp.asarray(5, jnp.int32), mu=fill(st.opt.mu, 0.5),
        nu=fill(st.opt.nu, 0.25)), step=jnp.asarray(5, jnp.int32))
    extra = {"reader": {"pos": np.arange(3, dtype=np.int64),
                        "epoch": np.int64(2)}}
    return cfg, st, rapi.resolve(cfg), extra


def test_reference_checkpoint_restores_in_port(ref_state, tmp_path):
    cfg, st, plan, extra = ref_state
    d = str(tmp_path)
    rsave(d, 5, st, plan=plan, label="train_state", extra=extra)
    _assert_leaves_equal(restore_untyped(d, 5), st)
    params, tplan, step = tconvert.load_checkpoint(d)
    assert step == 5 and tplan.to_json() == plan.to_json()
    _assert_leaves_equal(params, st.params)
    assert tconvert.load_plan(d) == tplan
    _assert_leaves_equal(restore_extra(d, 5, "reader"), extra["reader"])
    assert restore_extra(d, 5, "absent") is None
    # into the port's TrainState (in place)
    tcfg = tconfigs.get_smoke(SMOKE)
    tcfg = tcfg.replace(wasi=dataclasses.replace(tcfg.wasi, method="wsi"))
    model = tlm.init_lm(tcfg, device="cpu", seed=3)
    tstate = make_train_state(model, tcfg, TrainConfig(optimizer="adamw"))
    back = restore_checkpoint(d, 5, tstate)
    assert back.params is model and back.step == 5 and back.opt.step == 5
    want = state_from_reference(jax.tree.map(np.asarray, st), tcfg, "cpu")
    for n, p in want.params.named_parameters():
        assert torch.equal(dict(model.named_parameters())[n], p)
        assert torch.equal(back.opt.mu[n], want.opt.mu[n])
        assert torch.equal(back.opt.nu[n], want.opt.nu[n])


def test_port_checkpoint_restores_in_reference(ref_state, tmp_path):
    """The port's TrainState (carried in from the reference's) saved by
    the port and the reference's saved by the reference: the same files,
    the same manifest; the reference restores the port's both ways."""
    cfg, st, plan, extra = ref_state
    tcfg = tconfigs.get_smoke(SMOKE)
    tcfg = tcfg.replace(wasi=dataclasses.replace(tcfg.wasi, method="wsi"))
    tstate = state_from_reference(jax.tree.map(np.asarray, st), tcfg, "cpu")
    tplan = TPlan.from_json(plan.to_json())
    dp, dr = str(tmp_path / "port"), str(tmp_path / "ref")
    save_checkpoint(dp, 5, tstate, plan=tplan, label="train_state",
                    extra={"reader": {k: torch.from_numpy(np.asarray(v))
                                      for k, v in extra["reader"].items()}})
    rsave(dr, 5, st, plan=plan, label="train_state", extra=extra)
    assert load_manifest(dp, 5) == load_manifest(dr, 5)
    names = sorted(os.listdir(os.path.join(dr, "step_5")))
    assert sorted(os.listdir(os.path.join(dp, "step_5"))) == names
    for n in names:
        if n.endswith(".npy"):
            with open(os.path.join(dp, "step_5", n), "rb") as a, \
                    open(os.path.join(dr, "step_5", n), "rb") as b:
                assert a.read() == b.read(), n
    _assert_leaves_equal(rrestore_untyped(dp, 5), st)
    back = rrestore(dp, 5, jax.tree.map(jnp.zeros_like, st))
    _assert_leaves_equal(back, st)
    assert type(back).__name__ == "TrainState"
    rparams, rplan, step = rconvert.load_checkpoint(dp)
    assert step == 5 and rplan == plan
    _assert_leaves_equal(rparams, st.params)
    _assert_leaves_equal(rrestore_extra(dp, 5, "reader"), extra["reader"])


def test_bf16_leaves_byte_identical_and_read_back_as_bf16(tmp_path):
    w = np.random.default_rng(0).standard_normal((5, 7)).astype(np.float32)
    wj = jnp.asarray(w).astype(jnp.bfloat16)
    wt = torch.from_numpy(w).to(torch.bfloat16)
    assert np.array_equal(np.asarray(wj).view(np.int16),
                          wt.view(torch.int16).numpy())
    tree_r = {"w": wj, "s": jnp.asarray(w[0])}
    tree_t = {"w": wt, "s": torch.from_numpy(w[0].copy())}
    dr, dp = str(tmp_path / "ref"), str(tmp_path / "port")
    rsave(dr, 1, tree_r)
    save_checkpoint(dp, 1, tree_t)
    assert load_manifest(dp, 1) == load_manifest(dr, 1)
    assert load_manifest(dp, 1)["leaves"][1]["dtype"] == "bfloat16"
    for leaf in ("proc0_leaf0.npy", "proc0_leaf1.npy"):
        with open(os.path.join(dp, "step_1", leaf), "rb") as a, \
                open(os.path.join(dr, "step_1", leaf), "rb") as b:
            assert a.read() == b.read(), leaf
    for d in (dr, dp):
        back = restore_untyped(d, 1)
        assert back["w"].dtype == torch.bfloat16
        assert torch.equal(back["w"].view(torch.int16),
                           wt.view(torch.int16))
        assert back["s"].dtype == torch.float32


# ---------------------------------------------------------------------------
# the mechanics of tests/test_checkpoint.py, on the port
# ---------------------------------------------------------------------------

def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn(4, 8, generator=g),
            "b": [torch.arange(3), {"c": torch.tensor(7.0)}]}


def _zeros(t):
    return {"a": torch.zeros(4, 8),
            "b": [torch.zeros(3, dtype=torch.int64),
                  {"c": torch.tensor(0.0)}]}


def test_roundtrip_and_shape_mismatch(tmp_path):
    t = _tree()
    save_checkpoint(str(tmp_path), 5, t)
    _assert_leaves_equal(restore_checkpoint(str(tmp_path), 5, _zeros(t)), t)
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(str(tmp_path), 5, {"a": torch.zeros(3, 3),
                                              "b": [torch.zeros(3),
                                                    {"c": torch.zeros(())}]})


def test_latest_step_ignores_tmp_with_and_without_manifest(tmp_path):
    save_checkpoint(str(tmp_path), 3, _tree())
    os.makedirs(tmp_path / "step_9.tmp0")
    crashed = tmp_path / "step_11.tmp0"
    os.makedirs(crashed)
    (crashed / "manifest.json").write_text('{"step": 11}')
    assert latest_step(str(tmp_path)) == 3


def test_manager_sweeps_own_stale_tmp_on_startup(tmp_path):
    save_checkpoint(str(tmp_path), 2, _tree())
    for name in ("step_5.tmp0", "step_7.tmp0", "step_7.tmp1"):
        os.makedirs(tmp_path / name)
        (tmp_path / name / "manifest.json").write_text("{}")
    mgr = CheckpointManager(str(tmp_path), keep=2, process_index=0)
    assert sorted(os.listdir(tmp_path)) == ["step_2", "step_7.tmp1"]
    step, back = mgr.restore_latest(_zeros(_tree()))
    assert step == 2 and back is not None
    removed = sweep_stale_tmp(str(tmp_path))   # janitor mode
    assert [os.path.basename(r) for r in removed] == ["step_7.tmp1"]


def test_manager_async_retention_and_restore(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save_async(s, _tree(s))
    mgr.wait()
    steps = sorted(int(n.split("_")[1]) for n in os.listdir(tmp_path)
                   if n.startswith("step_"))
    assert steps == [3, 4]
    step, back = mgr.restore_latest(_zeros(_tree()))
    assert step == 4
    _assert_leaves_equal(back, _tree(4))
    empty = CheckpointManager(str(tmp_path / "empty"))
    assert empty.restore_latest(_zeros(_tree())) == (None, None)


def test_async_save_snapshots_at_the_call(tmp_path):
    """An in-place update after ``save_async`` returns does not reach the
    checkpoint: the snapshot is taken on the caller's thread."""
    t = _tree()
    want = t["a"].clone()
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_async(1, t)
    t["a"].add_(1.0)
    mgr.wait()
    assert torch.equal(restore_untyped(str(tmp_path), 1)["a"], want)


def test_multiprocess_saves_merge_not_clobber(tmp_path):
    t0, t1 = _tree(0), _tree(1)
    save_checkpoint(str(tmp_path), 1, t0, process_index=0)
    save_checkpoint(str(tmp_path), 1, t1, process_index=1)
    names = os.listdir(tmp_path / "step_1")
    assert any(n.startswith("proc0_") for n in names)
    assert any(n.startswith("proc1_") for n in names)
    _assert_leaves_equal(restore_checkpoint(str(tmp_path), 1, _zeros(t0),
                                            process_index=0), t0)
    _assert_leaves_equal(restore_checkpoint(str(tmp_path), 1, _zeros(t1),
                                            process_index=1), t1)
    # the reference reads the merged directory too
    back = rrestore_untyped(str(tmp_path), 1, process_index=1)
    np.testing.assert_array_equal(np.asarray(back["a"]), t1["a"].numpy())


def test_extra_names_must_be_plain_tokens(tmp_path):
    with pytest.raises(ValueError, match="plain filename token"):
        save_checkpoint(str(tmp_path), 1, _tree(), extra={"a/b": _tree()})


# ---------------------------------------------------------------------------
# restart of the training loop, and the launchers
# ---------------------------------------------------------------------------

def _smoke_run(steps: int, ckpt=None, every: int = 0, max_steps=None):
    cfg = tconfigs.get_smoke(SMOKE)
    cfg = cfg.replace(wasi=dataclasses.replace(cfg.wasi, method="wsi",
                                               refresh_every=2))
    tapi.install(tapi.resolve(cfg, batch=2, seq=8))
    tc = TrainConfig(optimizer="adamw", lr=1e-2, steps=steps,
                     checkpoint_every=every)
    model = tlm.init_lm(cfg, device="cpu", seed=5)
    state = make_train_state(model, cfg, tc)
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=8, global_batch=2,
                       seed=4)
    feed = lambda s: {k: v.long() for k, v in data.batch(s).items()}
    try:
        return train_loop(state, make_train_step(tlm.lm_loss, cfg, tc), feed,
                          tc, log_every=1, ckpt=ckpt, max_steps=max_steps,
                          log_fn=lambda line: None)
    finally:
        tapi.uninstall(cfg)


def test_train_loop_resumes_where_it_stopped(tmp_path):
    """6 steps at once against 3 steps, a restart from the checkpoint
    (async saves every 2 steps, the final one at 3), and 3 more: the same
    params, moments and step (CPU, the same order of operations)."""
    full, _ = _smoke_run(6)
    mgr = CheckpointManager(str(tmp_path), keep=2)
    part, h1 = _smoke_run(6, ckpt=mgr, every=2, max_steps=3)
    assert part.step == 3 and latest_step(str(tmp_path)) == 3
    assert sorted(os.listdir(tmp_path)) == ["step_2", "step_3"]
    resumed, h2 = _smoke_run(6, ckpt=CheckpointManager(str(tmp_path)),
                             every=2)
    assert [h["step"] for h in h1 + h2] == list(range(6))
    assert resumed.step == full.step == 6 and resumed.opt.step == 6
    a = dict(full.params.named_parameters())
    for n, p in resumed.params.named_parameters():
        assert torch.equal(p, a[n]), n
        assert torch.equal(resumed.opt.mu[n], full.opt.mu[n])
        assert torch.equal(resumed.opt.nu[n], full.opt.nu[n])
    assert latest_step(str(tmp_path)) == 6


def test_launchers_train_ckpt_then_serve_int8(tmp_path):
    d = str(tmp_path)
    cfg = tconfigs.get_smoke(SMOKE)
    cfg = cfg.replace(wasi=dataclasses.replace(cfg.wasi, method="wsi"))
    try:
        hist = tlaunch_train.main(["--device", "cpu", "--arch", SMOKE,
                                   "--wasi", "wsi", "--steps", "2",
                                   "--batch", "2", "--seq", "8",
                                   "--ckpt-dir", d, "--ckpt-every", "1"])
        assert len(hist) == 2 and latest_step(d) == 2
        m = load_manifest(d, 2)
        assert m["label"] == "train_state"
        assert json.dumps(m["plan"]["model"], sort_keys=True) == json.dumps(
            tapi.plan_of(cfg).to_json()["model"], sort_keys=True)
        # a second run finds the work done
        assert tlaunch_train.main(["--device", "cpu", "--arch", SMOKE,
                                   "--wasi", "wsi", "--steps", "2",
                                   "--batch", "2", "--seq", "8",
                                   "--ckpt-dir", d]) == []
        tapi.uninstall(cfg)
        s = tlaunch_serve.main(["--device", "cpu", "--ckpt", d, "--quant",
                                "int8", "--batch", "2", "--tokens", "3"])
        assert s["quantized"] and s["completed"] == 2
    finally:
        tapi.uninstall(cfg)
