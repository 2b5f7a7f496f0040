"""The dense decoder configs the port gained beside qwen2-0.5b:
tinyllama-1.1b (the paper's Fig. 7 model), stablelm-3b (layernorm, MHA of
head dim 80), granite-3-8b (rope theta 1e7, GQA 32/8), internvl2-26b
(precomputed embeddings as input) and gemma3-4b (5 ``local`` sliding-window
layers to 1 ``dense``, rolling KV caches, tied vocab, logit softcap),
against the reference's ``repro.configs`` and ``repro.models.lm``.

* Plans: ``api.resolve`` of each full config gives the reference's sites,
  dims, modes, ranks and kernel routes, with no weights built.
* Smoke models, weights drawn by the port from a seed and carried to the
  reference by ``api.bridge.to_reference`` (the port draws them in
  milliseconds; the reference's eager ``init_lm`` compiles op by op):
  logits, a prefill of ragged ``valid_len`` (last rows only) and
  teacher-forced decode with per-slot positions; gemma3's decode
  runs past its smoke window of 8, so its local layers' rolling caches
  wrap. Tolerance: f32 on both sides, sums in other orders: logits within
  rtol = atol = 2e-5 (values of order 1), cache leaves within 1e-5, as
  ``tests/test_torch_lm.py``.
* A tinyllama smoke checkpoint (untied ``lm_head``) crosses both ways,
  leaves equal bit for bit.
* Fig. 7's protocol (``benchmarks/fig7_tinyllama.py``): tinyllama smoke,
  B 8, S 32, SGD lr 0.3 momentum 0.9, 30 steps under ``wasi`` and
  ``none``, from the reference's weights and ASI states (key 233) and its
  ``SyntheticLM`` batches (seed 1, drawn by one jitted call, bit-equal to
  the eager draw), handed across. The
  first loss within 1e-5 relative; the last within 1e-4 relative (30 steps
  of f32 rounding in other orders compound, and under ``wasi`` the
  subspaces turn by rounding; the measured gaps, 1.4e-6 and 9.9e-8, stand
  beside the check).
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
    states_to_reference,
    to_reference,
)
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.config import TrainConfig
from repro_torch.models.blocks import PORTED_KINDS
from repro_torch.train.step import make_train_state, make_train_step

torch.set_num_threads(1)
NEW = ("tinyllama-1.1b", "stablelm-3b", "granite-3-8b", "internvl2-26b",
       "gemma3-4b")
FIELDS = ("name", "role", "in_dim", "out_dim", "mode", "rank", "bias",
          "kernel")
TOL = dict(rtol=2e-5, atol=2e-5)
CACHE_TOL = dict(rtol=1e-5, atol=1e-5)
CACHE = 24


def test_registry_lists_the_new_configs_and_the_local_kind():
    for name in NEW:
        assert name in tconfigs.ARCHS
        for get_t, get_r in ((tconfigs.get, rconfigs.get),
                             (tconfigs.get_smoke, rconfigs.get_smoke)):
            assert dataclasses.asdict(get_t(name)) == \
                dataclasses.asdict(get_r(name))
    assert "local" in PORTED_KINDS
    # the port keeps the reference's order among the archs it has
    assert list(tconfigs.ARCHS) == [a for a in rconfigs.ARCHS
                                    if a in tconfigs.ARCHS]


@pytest.mark.parametrize("arch", NEW)
def test_full_config_plan_matches_reference(arch):
    """Sites, dims, ranks and routes of the full config, without weights
    (tinyllama: q, o 2,048 -> 2,048 and gate, up, down at rank 512; k, v
    2,048 -> 256 at 128)."""
    rcfg, tcfg = rconfigs.get(arch), tconfigs.get(arch)
    ref = rapi.resolve(rcfg, batch=4, seq=512)
    got = tapi.resolve(tcfg, batch=4, seq=512)
    assert [tuple(getattr(s, f) for f in FIELDS) for s in got.specs] == \
        [tuple(getattr(s, f) for f in FIELDS) for s in ref.specs]
    assert [s.asi_ranks for s in got.specs] == \
        [s.asi_ranks for s in ref.specs]
    if arch == "tinyllama-1.1b":
        dims = {s.name: (s.in_dim, s.out_dim, s.rank) for s in got.specs}
        assert dims == {
            "attn/wq": (2048, 2048, 512), "attn/wk": (2048, 256, 128),
            "attn/wv": (2048, 256, 128), "attn/wo": (2048, 2048, 512),
            "mlp/gate": (2048, 5632, 512), "mlp/up": (2048, 5632, 512),
            "mlp/down": (5632, 2048, 512)}


def _as_ref(node):
    """A tree of the port's leaves as the reference's: jnp arrays, and its
    ``ASIState`` for the port's."""
    import repro.core.asi as rasi
    from repro_torch.core import asi as tasi
    if isinstance(node, tasi.ASIState):
        return rasi.ASIState(us=tuple(_as_ref(u) for u in node.us))
    if isinstance(node, dict):
        return {k: _as_ref(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_as_ref(v) for v in node)
    return None if node is None else jnp.asarray(node)


def _drawn(tcfg, seed, batch=None, seq=None):
    """The port's weights (and, at ``batch`` x ``seq``, ASI states) drawn
    from ``seed``, with the reference's trees of the same values."""
    model = tlm.init_lm(tcfg, device="cpu", seed=seed)
    states = None
    if batch is not None and tcfg.wasi.compress_acts:
        states = tlm.init_lm_states(tcfg, batch, seq, device="cpu",
                                    seed=seed)
    rstates = None if states is None else _as_ref(states_to_reference(states))
    return model, states, _as_ref(to_reference(model)), rstates


def _models(arch):
    rcfg, tcfg = rconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
    rapi.uninstall(rcfg)
    tapi.uninstall(tcfg)
    model, _, rparams, _ = _drawn(tcfg, 3)
    return rcfg, tcfg, rparams, model


def _kv_pairs(tc, rc):
    return list(zip([t for g in tc for c in g for t in c["kv"]],
                    jax.tree.leaves(rc)))


@pytest.mark.parametrize("arch", NEW)
def test_smoke_logits_prefill_and_decode_match_reference(arch):
    rcfg, tcfg, rparams, model = _models(arch)
    rng = np.random.default_rng(len(arch))
    toks = rng.integers(0, rcfg.vocab_size, (2, 11))
    want, *_ = rlm.lm_forward(rparams, jnp.asarray(toks, jnp.int32), rcfg)
    got, *_ = tlm.lm_forward(model, torch.from_numpy(toks), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    prompts = rng.integers(0, rcfg.vocab_size, (3, 6))
    vl = np.array([6, 2, 5])
    rc = rlm.init_lm_cache(rcfg, 3, CACHE, dtype=jnp.float32)
    want, rc = rlm.lm_prefill(rparams, jnp.asarray(prompts, jnp.int32), rcfg,
                              caches=rc, valid_len=jnp.asarray(vl, jnp.int32),
                              last_only=True)
    tc = tlm.init_lm_cache(tcfg, 3, CACHE, dtype=torch.float32, device="cpu")
    got, tc = tlm.lm_prefill(model, torch.from_numpy(prompts), tcfg,
                             caches=tc, valid_len=torch.from_numpy(vl),
                             last_only=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for a, b in _kv_pairs(tc, rc):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **CACHE_TOL)
    pos = vl.copy()
    steps = 9 if arch == "gemma3-4b" else 4
    rdecode = jax.jit(lambda p, t, c, q: rlm.lm_decode_step(p, t, c, q, rcfg))
    for step in range(steps):
        nxt = rng.integers(0, rcfg.vocab_size, (3, 1))
        want, rc = rdecode(rparams, jnp.asarray(nxt, jnp.int32), rc,
                           jnp.asarray(pos, jnp.int32))
        got, tc = tlm.lm_decode_step(model, torch.from_numpy(nxt), tc,
                                     torch.from_numpy(pos), tcfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                   err_msg=f"{arch} decode step {step}")
        for a, b in _kv_pairs(tc, rc):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       **CACHE_TOL)
        pos += 1
    if arch == "gemma3-4b":
        # every row wrote past the window: the local layers' caches rolled
        assert int(pos.min()) > tcfg.window
        local = tc[0][0]["kv"].k
        assert local.shape[2] == tcfg.window
        assert tc[0][-1]["kv"].k.shape[2] == CACHE   # the global layer


def test_internvl2_takes_precomputed_embeddings():
    """internvl2's frontend is a stub in both packages: float ``tokens``
    are (B, S, d) embeddings fed straight to the backbone."""
    rcfg, tcfg, rparams, model = _models("internvl2-26b")
    emb = np.random.default_rng(7).standard_normal(
        (2, 5, rcfg.d_model)).astype(np.float32)
    want, *_ = rlm.lm_forward(rparams, jnp.asarray(emb), rcfg)
    got, *_ = tlm.lm_forward(model, torch.from_numpy(emb), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _flat_np(node):
    return [np.asarray(x) for x in jax.tree.leaves(node)]


def test_tinyllama_checkpoint_with_untied_head_crosses_both_ways(tmp_path):
    rcfg = rconfigs.get_smoke("tinyllama-1.1b")
    tcfg = tconfigs.get_smoke("tinyllama-1.1b")
    assert not tcfg.tie_embeddings
    rapi.uninstall(rcfg)
    tapi.uninstall(tcfg)
    key = jax.random.PRNGKey(5)
    kw = dict(optimizer="sgd", lr=0.1, momentum=0.9, steps=1)
    _, _, rparams, rstates = _drawn(tcfg, 5, 2, 8)
    rstate = rmake_state(key, rparams, rcfg, RTrainConfig(**kw),
                         asi_states=rstates)
    assert "lm_head" in rstate.params
    rsave(str(tmp_path / "ref"), 1, rstate)
    template = state_from_reference(jax.tree.map(np.asarray, rstate), tcfg,
                                    "cpu")
    with torch.no_grad():
        for p in template.params.parameters():
            p.zero_()
    got = restore_checkpoint(str(tmp_path / "ref"), 1, template)
    out = state_to_reference(got)
    assert np.array_equal(out["params"]["lm_head"]["w"],
                          np.asarray(rstate.params["lm_head"]["w"]))
    for a, b in zip(_flat_np(out["params"]), _flat_np(rstate.params)):
        assert a.tobytes() == b.tobytes()
    # port -> reference
    model = tlm.init_lm(tcfg, device="cpu", seed=9)
    state = make_train_state(model, tcfg, TrainConfig(**kw),
                             asi_states=tlm.init_lm_states(tcfg, 2, 8,
                                                           device="cpu"))
    save_checkpoint(str(tmp_path / "port"), 1, state)
    back = rrestore(str(tmp_path / "port"), 1, rstate)
    want = state_to_reference(state)["params"]
    for a, b in zip(_flat_np(back.params), _flat_np(want)):
        assert a.tobytes() == b.tobytes()


# the gaps this test measured on its own inputs (last loss, relative):
# wasi 1.4e-6, none 9.9e-8
FIG7_LAST_RTOL = 1e-4


@pytest.mark.parametrize("method", ["wasi", "none"])
def test_fig7_protocol_matches_reference(method):
    b, s, steps = 8, 32, 30
    base = rconfigs.get_smoke("tinyllama-1.1b")
    rcfg = base.replace(wasi=dataclasses.replace(base.wasi, method=method))
    base = tconfigs.get_smoke("tinyllama-1.1b")
    tcfg = base.replace(wasi=dataclasses.replace(base.wasi, method=method))
    rapi.uninstall(rcfg)
    tapi.uninstall(tcfg)
    key = jax.random.PRNGKey(233)
    params = rlm.init_lm(key, rcfg)
    states = (rlm.init_lm_states(key, rcfg, b, s)
              if rcfg.wasi.compress_acts else None)
    kw = dict(optimizer="sgd", lr=0.3, momentum=0.9, steps=steps,
              checkpoint_every=0)
    rstate = rmake_state(key, params, rcfg, RTrainConfig(**kw),
                         asi_states=states)
    model = from_reference(jax.tree.map(np.asarray, params), tcfg, "cpu")
    tstates = (None if states is None else
               states_from_reference(jax.tree.map(np.asarray, states), "cpu"))
    state = make_train_state(model, tcfg, TrainConfig(**kw),
                             asi_states=tstates)
    rstep = jax.jit(rmake_step(rlm.lm_loss, rcfg, RTrainConfig(**kw)))
    step = make_train_step(tlm.lm_loss, tcfg, TrainConfig(**kw))
    draw = jax.jit(RSyntheticLM(vocab_size=rcfg.vocab_size, seq_len=s,
                                global_batch=b, seed=1).batch)
    losses = []
    for i in range(steps):
        batch = jax.tree.map(np.asarray, draw(i))
        rstate, rm = rstep(rstate, jax.tree.map(jnp.asarray, batch))
        state, m = step(state, {k: torch.tensor(v).long()
                                for k, v in batch.items()})
        losses.append((float(m["loss"]), float(rm["loss"])))
    assert np.isfinite(losses).all()
    np.testing.assert_allclose(losses[0][0], losses[0][1], rtol=1e-5)
    np.testing.assert_allclose(losses[-1][0], losses[-1][1],
                               rtol=FIG7_LAST_RTOL)
    assert losses[-1][1] < losses[0][1]
