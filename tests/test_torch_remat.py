"""``remat="block"``: one repeat of a group's pattern under a non-reentrant
``torch.utils.checkpoint`` (``models/lm.py``), the port's counterpart of the
reference's ``jax.checkpoint`` of its scan body.

* Port ``block`` against port ``none`` (f32, the same weights, states and
  batch): loss, every gradient and the refreshed ASI states bit-equal. The
  recompute runs the same ops on the same inputs on the CPU, so no
  tolerance is needed.
* Port ``block`` against the reference's ``block``: 4 steps of
  ``make_train_step`` on tinyllama smoke with ``remat="block"`` on both
  sides, under ``none``, ``wsi``, ``wasi`` and ``asi``, AdamW and
  SGD+momentum, at the tolerances of ``tests/test_torch_wasi_train.py``:
  losses, ``ce`` and ``ppl_proxy`` within 1e-5 relative, grad_norm within
  1e-4; SGD params within 1e-5 of each leaf's scale; AdamW params within
  0.3 lr absolute and moments within 1e-3 of their scale; the ASI factors
  within that file's ``ASI_TOL``.
* What the residual probe (``utils.memprof.measured_residual_bytes``) counts
  under a checkpoint: the checkpoint's tensor inputs, each storage once, and
  nothing computed inside it. Counts, no tolerance.
* The recompute launches every forward kernel a second time and the
  backward kernels once (counted on the CPU through the plain versions the
  wrappers call), and serving never checkpoints.
"""
import dataclasses
import functools
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

import repro.configs as rconfigs
import repro.models.lm as rlm
import repro.utils.memprof as rmem
import repro_torch.configs as tconfigs
import repro_torch.models.lm as tlm
from repro import api as rapi
from repro.config import TrainConfig as RTrainConfig
from repro.data.synthetic import SyntheticLM as RSyntheticLM
from repro.train.step import make_train_state as rmake_state
from repro.train.step import make_train_step as rmake_step
from repro_torch import api as tapi
from repro_torch.api.bridge import (
    state_from_reference,
    state_to_reference,
)
from repro_torch.config import TrainConfig
from repro_torch.core import asi as tasi
from repro_torch.kernels import ops, ref
from repro_torch.train.step import make_train_step, value_and_grad
from repro_torch.utils.memprof import measured_residual_bytes

torch.set_num_threads(1)
KEY = jax.random.PRNGKey(0)
B, S, STEPS = 4, 16, 4
ARCH = "tinyllama-1.1b"
METHODS = ("none", "wsi", "wasi", "asi")


def _cfg(pkg, arch, method, remat):
    """``arch``'s smoke config under ``method`` and ``remat``, refreshing
    every 2 steps."""
    c = pkg.get_smoke(arch)
    return c.replace(remat=remat, wasi=dataclasses.replace(
        c.wasi, method=method, refresh_every=2))


def _port(arch, method, remat, b=B, s=S, seed=0):
    cfg = _cfg(tconfigs, arch, method, remat)
    tapi.uninstall(cfg)
    tapi.install(tapi.resolve(cfg, batch=b, seq=s))
    model = tlm.init_lm(cfg, device="cpu", seed=seed)
    model.requires_grad_(True)
    states = (tlm.init_lm_states(cfg, b, s, device="cpu", seed=seed)
              if cfg.wasi.compress_acts else None)
    return cfg, model, states


def _batch(b=B, s=S, seed=1):
    g = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, 256, (b, s), generator=g)
    return {"tokens": toks, "labels": torch.roll(toks, -1, 1)}


def _leaves(tree) -> list:
    out: list = []
    tlm.map_states(out.append, tree)
    return out


# ---------------------------------------------------------------------------
# block against none, in the port
# ---------------------------------------------------------------------------

CASES = [(ARCH, m) for m in METHODS] + [("gemma3-4b", "wasi"),
                                        ("zamba2-7b", "wasi")]


@pytest.mark.parametrize("arch,method", CASES)
def test_block_equals_none_bit_for_bit(arch, method):
    """gemma3's body is a (local, local, dense) pattern, zamba2's a
    (mamba2, mamba2, mamba2_attn) pattern with the shared block's leaves
    among the checkpoint's inputs."""
    out = {}
    for remat in ("none", "block"):
        cfg, model, states = _port(arch, method, remat)
        out[remat] = value_and_grad(tlm.lm_loss, model, _batch(), cfg,
                                    states)
    (l0, m0, g0, s0), (l1, m1, g1, s1) = out["none"], out["block"]
    assert torch.equal(l0, l1)
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
    assert g0.keys() == g1.keys()
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k
    if states_on := s0 is not None:
        a, b = _leaves(s0), _leaves(s1)
        assert len(a) == len(b) > 0
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert states_on == (method in ("wasi", "asi"))


def _counting(monkeypatch) -> Counter:
    """Count the plain versions each kernel wrapper calls on the CPU."""
    calls: Counter = Counter()
    for mod, name in ((ref, "flash_attention_ref"),
                      (ref, "lowrank_sketch_ref"),
                      (ops, "lowrank_bwd_fused")):
        fn = getattr(mod, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(mod, name, counted)
    return calls


@pytest.mark.parametrize("method", ["wsi", "wasi"])
def test_recompute_runs_every_forward_kernel_again(monkeypatch, method):
    """Per training step of L layers, 7 factored sites a layer: ``wsi``
    runs 7 L sketch forwards (#2) and L attentions (#7) under ``none``,
    twice that under ``block``, and 7 L backwards (#3) under both; ``wasi``
    runs only the attentions. The counts chip_smoke.py holds the card to."""
    calls = _counting(monkeypatch)
    got = {}
    for remat in ("none", "block"):
        cfg, model, states = _port(ARCH, method, remat)
        calls.clear()
        value_and_grad(tlm.lm_loss, model, _batch(), cfg, states)
        got[remat] = dict(calls)
    n = cfg.n_layers
    if method == "wsi":
        assert got["none"] == {"lowrank_sketch_ref": 7 * n,
                               "flash_attention_ref": n,
                               "lowrank_bwd_fused": 7 * n}
        assert got["block"] == {"lowrank_sketch_ref": 14 * n,
                                "flash_attention_ref": 2 * n,
                                "lowrank_bwd_fused": 7 * n}
    else:
        assert got == {"none": {"flash_attention_ref": n},
                       "block": {"flash_attention_ref": 2 * n}}


@pytest.mark.parametrize("arch", [ARCH, "gemma3-4b", "zamba2-7b"])
def test_one_checkpoint_per_repeat_and_none_when_serving(monkeypatch, arch):
    """A body is one repeat of a group's pattern (every pattern position
    at one index), so a forward makes sum(repeat) checkpoints; without
    grad, or with caches, it makes none."""
    seen = []

    def spy(fn, *a, **kw):
        seen.append(kw)
        return checkpoint(fn, *a, **kw)

    monkeypatch.setattr(tlm, "checkpoint", spy)
    cfg, model, states = _port(arch, "wasi", "block")
    tlm.lm_loss(model, _batch(), cfg, states=states)
    assert len(seen) == sum(g.repeat for g in cfg.groups)
    assert all(kw == {"use_reentrant": False, "preserve_rng_state": False}
               for kw in seen)
    seen.clear()
    with torch.no_grad():
        tlm.lm_forward(model, _batch()["tokens"], cfg)
    caches = tlm.init_lm_cache(cfg, B, 2 * S, dtype=torch.float32,
                               device="cpu")
    tlm.lm_prefill(model, _batch()["tokens"], cfg, caches=caches)
    assert seen == []


@pytest.mark.parametrize("remat", ["none", "block"])
def test_checkpointed_body_reads_pos_and_valid_len(monkeypatch, remat):
    """The reference's scan body hands ``pos`` and ``valid_len`` to every
    block; so does the checkpointed one, in the forward and in the
    recompute, and the values match ``none``'s."""
    seen = []
    apply_block = tlm.apply_block

    def spy(*a, **kw):
        seen.append((kw["pos"], kw["valid_len"]))
        return apply_block(*a, **kw)

    monkeypatch.setattr(tlm, "apply_block", spy)
    cfg, model, _ = _port(ARCH, "wsi", remat)
    x = tlm._embed(model, _batch()["tokens"], cfg)
    pos, vl = torch.tensor(3), torch.tensor([S, S - 5, 1, S])
    out, *_ = tlm.lm_backbone(model, x, cfg, pos=pos, valid_len=vl)
    out.sum().backward()
    runs = 2 if remat == "block" else 1
    assert len(seen) == runs * cfg.n_layers
    assert all(p is pos and v is vl for p, v in seen)
    cfg_none, model_none, _ = _port(ARCH, "wsi", "none")
    with torch.no_grad():
        want, *_ = tlm.lm_backbone(model_none, x.detach(), cfg_none,
                                   pos=pos, valid_len=vl)
    assert torch.equal(out.detach(), want)


# ---------------------------------------------------------------------------
# what the probe counts under a checkpoint
# ---------------------------------------------------------------------------

def test_probe_sees_a_checkpoints_inputs_and_nothing_inside():
    """sin saves its input, so sin(sin(x)) saves x and sin(x), and exp
    saves its output: 3 storages of 8 x 64 f32 without the checkpoint, x
    alone with it."""
    x = torch.randn(8, 64)

    def body(t):
        return torch.exp(torch.sin(torch.sin(t)))

    plain = measured_residual_bytes(body, x)
    kept = measured_residual_bytes(
        lambda t: checkpoint(body, t, use_reentrant=False), x)
    assert (plain.total_bytes, plain.n_arrays) == (3 * 2048, 3)
    assert (kept.total_bytes, kept.n_arrays) == (2048, 1)


def test_probe_counts_each_kept_input_of_a_body_once():
    """One tinyllama-smoke layer under ``wasi``: the checkpoint keeps the
    hidden state, the layer's parameter views and its ASI state slices.
    The probe reports exactly their storages (a view counts its stacked
    leaf's, once however many views share it), and no tensor the body
    computes."""
    cfg, model, states = _port(ARCH, "wasi", "block")
    params = [model.layer_views()[0][0][0]]
    st = [tlm._layer_states(states[0][0], 0)]
    x = torch.randn(B, S, cfg.d_model)
    rep = measured_residual_bytes(
        lambda h: tlm._checkpointed_pattern(cfg.groups[0].pattern, cfg, h,
                                            params, st, None)[0], x)
    want = {}
    for t in [x] + _leaves(params) + _leaves(st):
        storage = t.untyped_storage()
        want[storage.data_ptr()] = storage.nbytes()
    assert rep.n_arrays > 1 + len(_leaves(params))   # the states are in
    assert rep.storages == frozenset(want)
    assert rep.total_bytes == sum(want.values())


@functools.cache
def _reference_start(method):
    """The reference's weights and ASI states under ``method`` (``KEY``),
    drawn once for every test of this file: its eager ``init_lm`` compiles
    op by op. They do not depend on ``remat``."""
    rcfg = _cfg(rconfigs, ARCH, method, "block")
    rapi.uninstall(rcfg)
    rapi.install(rapi.resolve(rcfg, batch=B, seq=S))
    params = rlm.init_lm(KEY, rcfg)
    st = (rlm.init_lm_states(KEY, rcfg, B, S) if rcfg.wasi.compress_acts
          else None)
    return params, st


@functools.cache
def _reference_batches():
    """The reference's ``SyntheticLM`` batches (seed 1) for ``STEPS``
    steps, as numpy: one jitted draw (bit-equal to the eager one, which
    compiles anew for every step)."""
    data = RSyntheticLM(vocab_size=rconfigs.get_smoke(ARCH).vocab_size,
                        seq_len=S, global_batch=B, seed=1)
    draw = jax.jit(data.batch)
    return [jax.tree.map(np.asarray, draw(i)) for i in range(STEPS)]


def _reference_bytes(method, remat):
    rcfg = _cfg(rconfigs, ARCH, method, remat)
    rapi.uninstall(rcfg)
    rapi.install(rapi.resolve(rcfg, batch=B, seq=S))
    params, st = _reference_start(method)
    batch = {k: jnp.asarray(v.numpy()) for k, v in _batch().items()}
    return rmem.measured_residual_bytes(
        lambda p: rlm.lm_loss(p, batch, rcfg, states=st), params,
        has_aux=True).total_bytes


@pytest.mark.parametrize("method", METHODS)
def test_saved_bytes_fall_under_block_as_the_references_do(method):
    """Every method saves fewer bytes under ``block``, in the port and in
    the reference's probe (tinyllama-smoke at B 8, S 32, the reference
    keeps 0.23x of ``none``'s bytes under ``none``, 0.20x under ``wsi``,
    0.28x under ``wasi``, whose ASI states ride into every checkpoint as
    inputs; measured with ``repro.utils.memprof``)."""
    got = {}
    for remat in ("none", "block"):
        cfg, model, states = _port(ARCH, method, remat)
        got[remat] = measured_residual_bytes(
            lambda: tlm.lm_loss(model, _batch(), cfg,
                                states=states)).total_bytes
    want = {remat: _reference_bytes(method, remat)
            for remat in ("none", "block")}
    assert got["block"] < got["none"], got
    assert want["block"] < want["none"], want


# ---------------------------------------------------------------------------
# port block against the reference's block
# ---------------------------------------------------------------------------

GATES = {"adamw": dict(optimizer="adamw", lr=1e-2, weight_decay=1e-4),
         "sgd_momentum": dict(optimizer="sgd", lr=0.3, momentum=0.9)}
# tests/test_torch_wasi_train.py's ASI_TOL
ASI_TOL = {("wasi", "adamw"): 2e-2, ("wasi", "sgd_momentum"): 4e-4,
           ("asi", "adamw"): 2e-3, ("asi", "sgd_momentum"): 6e-5}


def _tree_close(got, want, rel, abs_=0.0):
    fg, tg = jax.tree.flatten(got)
    fw, tw = jax.tree.flatten(jax.tree.map(np.asarray, want))
    assert tg == tw
    for g, w in zip(fg, fw):
        np.testing.assert_allclose(
            g, w, rtol=0, atol=rel * max(np.abs(w).max(), 1e-30) + abs_)


def _as_ref(node):
    import repro.core.asi as rasi
    if isinstance(node, tasi.ASIState):
        return rasi.ASIState(us=tuple(node.us))
    if isinstance(node, dict):
        return {k: _as_ref(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_as_ref(v) for v in node]
    return node


@pytest.mark.parametrize("gate", sorted(GATES))
@pytest.mark.parametrize("method", METHODS)
def test_block_training_matches_reference_block(method, gate):
    rcfg = _cfg(rconfigs, ARCH, method, "block")
    tcfg = _cfg(tconfigs, ARCH, method, "block")
    rapi.uninstall(rcfg)
    tapi.uninstall(tcfg)
    rapi.install(rapi.resolve(rcfg, batch=B, seq=S))
    tapi.install(tapi.resolve(tcfg, batch=B, seq=S))
    kw = dict(GATES[gate], steps=STEPS, clip_norm=2.0, checkpoint_every=0)
    params, st = _reference_start(method)
    rstate = rmake_state(KEY, params, rcfg, RTrainConfig(**kw),
                         asi_states=st)
    state = state_from_reference(jax.tree.map(np.asarray, rstate), tcfg,
                                 "cpu")
    rstep = jax.jit(rmake_step(rlm.lm_loss, rcfg, RTrainConfig(**kw)))
    step = make_train_step(tlm.lm_loss, tcfg, TrainConfig(**kw))
    for i, b in enumerate(_reference_batches()):
        rstate, rm = rstep(rstate, jax.tree.map(jnp.asarray, b))
        state, m = step(state, {k: torch.tensor(v).long()
                                for k, v in b.items()})
        for k in ("loss", "grad_norm", "lr", "ce", "ppl_proxy"):
            rtol = 1e-4 if k == "grad_norm" else 1e-5
            np.testing.assert_allclose(float(m[k]), float(rm[k]), rtol=rtol,
                                       err_msg=f"step {i} {k}")
    out = state_to_reference(state)
    if st is not None:
        _tree_close(_as_ref(out["asi"]), rstate.asi, ASI_TOL[method, gate])
    if gate == "adamw":
        _tree_close(out["params"], rstate.params, 0.0,
                    0.3 * GATES[gate]["lr"])
        _tree_close(out["mu"], rstate.opt.mu, 1e-3)
        _tree_close(out["nu"], rstate.opt.nu, 1e-3)
    else:
        _tree_close(out["params"], rstate.params, 1e-5)
        _tree_close(out["mu"], rstate.opt.mu, 1e-5)
