"""The port's encoder-decoder family (``models/encdec.py``, whisper smoke
in f32) against the reference's: the sinusoidal table, the
cross-attention branch of ``apply_attention``, ``encode``'s memory,
``decode_train``'s logits and ``encdec_loss`` with and without ASI states
under ``remat`` ``none`` and ``block``, every gradient, the 4-step
training gate, and greedy ``encdec_decode_step`` tokens. Params, ASI
states and the reference's ``SyntheticAudio`` batches are drawn once per
file and handed to both packages as numpy (``api.bridge``).

Tolerances (f32 on both sides, sums in other orders):

* forward values within rtol 1e-5 and 1e-5 of the reference's RMS;
  gradients of every leaf within 1e-4 of the leaf's gradient scale;
* the gate (``wsi`` and ``wasi``, SGD+momentum and AdamW, the WSI refresh
  every 2 steps, so after steps 2 and 4): the tolerances of
  ``tests/test_torch_wasi_train.py``: losses and ``ce`` within 1e-5
  relative, grad_norm 1e-4; SGD+momentum params and momenta within 1e-5
  of each leaf's scale; AdamW params within 0.3 lr absolute, moments
  within 1e-3 of their scale; the ASI factors within ``ASI_TOL``, about
  4x the reference's own rounding spread on these inputs
  (``scripts/encdec_gate_spread.py``: its jitted runs against its eager
  run and 4 runs from params moved by one ulp; after the 4 ``wasi`` steps
  the largest reading is 1.78e-4 of the scale under SGD+momentum and
  4.33e-2 under AdamW, the port read 2.82e-4 and 1.80e-2). Under AdamW
  the factors keep little of their start: each step's subspace iteration
  starts from factors the last step's rounding turned, at smoke ranks
  with small gaps between kept and dropped singular values;
* greedy decode: the same 8 tokens unless a step's top-2 margin is
  within the logits' tolerance (the near-tie rule of ``PERF.md`` §2); each
  step's logits within 1e-5 of their RMS.

On the CPU every wrapper runs its plain version, so no launch is counted.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as rconfigs
import repro.models.encdec as red
import repro.nn.attention as rattn
import repro.nn.rotary as rrot
import repro_torch.configs as tconfigs
import repro_torch.models.encdec as ted
import repro_torch.nn.attention as tattn
import repro_torch.nn.rotary as trot
from repro import api as rapi
from repro.config import TrainConfig as RTrainConfig
from repro.core.asi import ASIState as RASIState
from repro.data.synthetic import SyntheticAudio as RSyntheticAudio
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
from repro_torch.config import TrainConfig
from repro_torch.data.synthetic import SyntheticAudio
from repro_torch.kernels import ops
from repro_torch.launch import train as tlaunch
from repro_torch.train.step import make_train_step, value_and_grad

torch.set_num_threads(1)
KEY = jax.random.PRNGKey(0)
B, S, STEPS, NEW = 4, 16, 4, 8
ARCH = "whisper-tiny"
GATES = {"sgd_momentum": dict(optimizer="sgd", lr=0.05, momentum=0.9),
         "adamw": dict(optimizer="adamw", lr=1e-2, weight_decay=1e-4)}
ASI_TOL = {"sgd_momentum": 7e-4, "adamw": 0.17}
FIELDS = ("name", "role", "in_dim", "out_dim", "mode", "rank", "bias",
          "kernel")


@functools.lru_cache(maxsize=None)
def _cfgs(method="wasi", remat="none"):
    """Both packages' whisper smoke configs under ``method`` and
    ``remat``, refreshing every 2 steps, with their plans (batch B, S
    decoder tokens) installed once per file."""
    def m(c):
        return c.replace(remat=remat, wasi=dataclasses.replace(
            c.wasi, method=method, refresh_every=2))
    rcfg, tcfg = m(rconfigs.get_smoke(ARCH)), m(tconfigs.get_smoke(ARCH))
    rapi.uninstall(rcfg)
    tapi.uninstall(tcfg)
    rapi.install(rapi.resolve(rcfg, batch=B, seq=S))
    tapi.install(tapi.resolve(tcfg, batch=B, seq=S))
    return rcfg, tcfg


@functools.lru_cache(maxsize=None)
def _draws():
    """Params, ASI states and 4 batches, drawn once as numpy: the params
    and states by the port's ``init_encdec``/``init_encdec_states`` (the
    reference's eager draws take ~10 s of this file's budget; both
    packages start from the same numpy all the same, and
    ``test_trees_and_states_cross_the_bridge`` holds their layout to the
    reference's), the batches by the reference's ``SyntheticAudio``. wsi
    and wasi share the factored layout, so one tree serves both."""
    rcfg, tcfg = _cfgs("wasi")
    params = to_reference(ted.init_encdec(tcfg, device="cpu", seed=0))
    port = states_to_reference(ted.init_encdec_states(tcfg, B, S,
                                                      device="cpu"))
    # the reference's own ASIState type, so its jitted step sees one
    # pytree structure from the first step on
    states = jax.tree.map(lambda st: RASIState(us=tuple(st.us)), port,
                          is_leaf=lambda n: hasattr(n, "us"))
    data = RSyntheticAudio(vocab_size=rcfg.vocab_size, enc_seq=rcfg.enc_seq,
                           d_model=rcfg.d_model, seq_len=S, global_batch=B,
                           seed=0)
    batches = [jax.tree.map(np.asarray, data.batch(i)) for i in range(STEPS)]
    return params, states, batches


@functools.lru_cache(maxsize=None)
def _reference_loss(method):
    """The reference's ``encdec_loss`` under ``method``, jitted once: the
    gradient pass and both optimizers' train steps reuse its trace."""
    rcfg, _ = _cfgs(method)
    return jax.jit(lambda p, b, s: red.encdec_loss(p, b, rcfg, states=s))


def _torch_batch(b):
    return {"frames": torch.tensor(b["frames"]),
            "tokens": torch.tensor(b["tokens"]).long(),
            "labels": torch.tensor(b["labels"]).long()}


def _close(got, want, rtol=1e-5, rms=1e-5):
    want = np.asarray(want, np.float32)
    scale = float(np.sqrt(np.mean(want ** 2)))
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=rtol,
                               atol=rms * scale)


def _tree_close(got, want, rel, abs_=0.0):
    fg, tg = jax.tree.flatten(got)
    fw, tw = jax.tree.flatten(jax.tree.map(np.asarray, want))
    assert tg == tw
    for g, w in zip(fg, fw):
        np.testing.assert_allclose(
            np.asarray(g, np.float32), w, rtol=0,
            atol=rel * max(np.abs(w).max(), 1e-30) + abs_)


# ---------------------------------------------------------------------------
# pieces: the table, the cross-attention, the plan, the bridge, the data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seq,dim", [(16, 32), (7, 3), (5, 2), (1500, 384)])
def test_sinusoidal_embedding_matches_reference(seq, dim):
    """Dims 2 and 3 take the reference's ``max(dim // 2 - 1, 1)``
    denominator at 1; a row picked by ``sinusoidal_angles`` (the decode
    step's) is that row of the table, bit for bit. Tolerance: the angles
    reach ``seq`` radians in f32, where one ulp of the angle is ``seq``
    f32 epsilons and the two libraries' exp, sin and cos may part by an
    ulp; 4 such epsilons (3.6e-4 at whisper's 1,500 frames, 1.4e-4 read
    there)."""
    want = np.asarray(rrot.sinusoidal_embedding(seq, dim))
    got = trot.sinusoidal_embedding(seq, dim)
    eps = float(np.finfo(np.float32).eps)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=4 * eps * max(seq, 4))
    row = trot.sinusoidal_angles(torch.tensor([seq - 1]), dim)
    assert torch.equal(row[0], got[seq - 1])
    assert trot.sinusoidal_embedding(seq, dim, torch.bfloat16).dtype == \
        torch.bfloat16


@pytest.mark.parametrize("sq", [1, 5])
def test_cross_attention_matches_reference(sq):
    """``apply_attention(kv_memory=)``: q from x, k and v from the memory
    (16 frames), no mask, the cache returned as it came. The paged
    refusal stays ahead of the branch."""
    rcfg, tcfg = _cfgs("wsi")
    params = _draws()[0]
    p = jax.tree.map(lambda a: a[0], params["dec"]["cross_attn"])
    model = from_reference(params, tcfg, "cpu")
    tp = {k: {n: t[0] for n, t in v.items()}
          for k, v in model.dec["cross_attn"].items()}
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, sq, 32)).astype(np.float32)
    mem = rng.standard_normal((2, 16, 32)).astype(np.float32)
    want, wcache, _ = rattn.apply_attention(
        p, jnp.asarray(x), rcfg, causal=False, kv_memory=jnp.asarray(mem))
    ops.reset_launches()
    got, cache, _ = tattn.apply_attention(
        tp, torch.tensor(x), tcfg, causal=False, kv_memory=torch.tensor(mem),
        cache=None)
    assert cache is None and wcache is None
    _close(got.numpy(), want)
    assert set(ops.launch_counts().values()) == {0}
    with pytest.raises(ValueError, match="causal full attention only"):
        tattn.apply_attention(
            tp, torch.tensor(x), tcfg, kv_memory=torch.tensor(mem),
            cache=tattn.PagedKVCache(k=torch.zeros(3, 4, 2, 16),
                                     v=torch.zeros(3, 4, 2, 16)),
            page_table=torch.zeros(2, 1, dtype=torch.long))


@pytest.mark.parametrize("full", [False, True])
def test_plan_matches_reference(full):
    """Sites, dims, ranks and routes of whisper's plan (the full config's
    six sites at rank 128), as the reference resolves them."""
    get_r = rconfigs.get if full else rconfigs.get_smoke
    get_t = tconfigs.get if full else tconfigs.get_smoke
    rcfg, tcfg = get_r(ARCH), get_t(ARCH)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(rcfg)
    want = rapi.resolve(rcfg, batch=4, seq=448)
    got = tapi.resolve(tcfg, batch=4, seq=448)
    assert [tuple(getattr(s, f) for f in FIELDS) for s in got.specs] == \
        [tuple(getattr(s, f) for f in FIELDS) for s in want.specs]
    assert [s.name for s in got.specs] == [
        "attn/wq", "attn/wk", "attn/wv", "attn/wo", "mlp/up", "mlp/down"]
    if full:
        assert {s.rank for s in got.specs} == {128}


def test_trees_and_states_cross_the_bridge():
    """``init_encdec``/``init_encdec_states`` of both packages: one tree,
    one set of shapes; params and ASI states (``cross_attn`` {}) carried
    both ways bit for bit, in the reference's flatten order."""
    rcfg, tcfg = _cfgs("wasi")
    params, states, _ = _draws()
    want = jax.eval_shape(lambda k: red.init_encdec(k, rcfg), KEY)
    assert jax.tree.map(lambda x: tuple(x.shape), params) == \
        jax.tree.map(lambda x: tuple(x.shape), want)
    back = to_reference(from_reference(params, tcfg, "cpu"))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)
    tst = ted.init_encdec_states(tcfg, B, S, device="cpu")
    want = jax.eval_shape(lambda k: red.init_encdec_states(k, rcfg, B, S),
                          KEY)
    assert tst["dec"]["cross_attn"] == {} == want["dec"]["cross_attn"]
    got = states_to_reference(tst)
    assert jax.tree.map(lambda x: tuple(x.shape), got) == \
        jax.tree.map(lambda x: tuple(x.shape), want)
    carried = states_to_reference(states_from_reference(states, "cpu"))
    assert len(jax.tree.leaves(carried)) == len(jax.tree.leaves(states))
    for a, b in zip(jax.tree.leaves(carried), jax.tree.leaves(states)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="missing"):
        from_reference({k: v for k, v in params.items() if k != "enc"},
                       tcfg, "cpu")


def test_synthetic_audio_batches():
    """The reference's layout and dtypes: standard-normal frames, labels
    the tokens shifted by one; a pure function of (seed, step)."""
    data = SyntheticAudio(vocab_size=128, enc_seq=16, d_model=32, seq_len=S,
                          global_batch=B, seed=3)
    b = data.batch(2)
    assert b["frames"].shape == (B, 16, 32) and b["frames"].dtype == \
        torch.float32
    assert b["tokens"].shape == b["labels"].shape == (B, S)
    assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])
    assert int(b["tokens"].min()) >= 0 and int(b["tokens"].max()) < 128
    again = data.batch(2)
    assert all(torch.equal(b[k], again[k]) for k in b)
    assert not torch.equal(data.batch(3)["frames"], b["frames"])
    assert data.batch(0, batch_size=2)["frames"].shape[0] == 2


# ---------------------------------------------------------------------------
# the forward, the loss, the gradients
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _reference_pass(method):
    """The reference's memory and logits (the forward's values do not
    depend on ASI states), and its loss, new ASI states and the gradient
    of every leaf on batch 0: ``wsi`` without states (every site on the
    fused factored route), ``wasi`` with them."""
    params, states, batches = _draws()
    b = jax.tree.map(jnp.asarray, batches[0])
    (loss, (ns, _)), grads = jax.jit(jax.value_and_grad(
        _reference_loss(method), has_aux=True))(
            params, b, states if method == "wasi" else None)
    return jax.tree.map(np.asarray, (*_reference_forward(), loss, ns, grads))


@functools.lru_cache(maxsize=None)
def _reference_forward():
    """The reference's memory and logits on batch 0, without states."""
    rcfg, _ = _cfgs("wsi")
    params, _, batches = _draws()

    @jax.jit
    def forward(p, b):
        mem, _ = red.encode(p, b["frames"], rcfg)
        return mem, red.decode_train(p, b["tokens"], mem, rcfg)[0]

    return forward(params, jax.tree.map(jnp.asarray, batches[0]))


@pytest.mark.parametrize("method", ["wsi", "wasi"])
@pytest.mark.parametrize("remat", ["none", "block"])
def test_encode_decode_and_loss_match_reference(method, remat):
    """``wsi``: no states; ``wasi``: with ASI states, whose refreshed
    factors are held to 3.5e-4 of their scale, about 4x the reference's
    own jit-vs-eager spread after this one pass (8.5e-5; the port read
    5.3e-5; ``scripts/encdec_gate_spread.py``)."""
    _, tcfg = _cfgs(method, remat)
    params, states, batches = _draws()
    mem, logits, loss, rns, _ = _reference_pass(method)
    model = from_reference(params, tcfg, "cpu")
    tst = states_from_reference(states, "cpu") if method == "wasi" else None
    tb = _torch_batch(batches[0])
    ops.reset_launches()
    tmem, tens = ted.encode(model, tb["frames"], tcfg, states=tst)
    tlogits, tdns = ted.decode_train(model, tb["tokens"], tmem, tcfg,
                                     states=tst)
    tloss, (tns, met) = ted.encdec_loss(model, tb, tcfg, states=tst)
    _close(tmem.numpy(), mem)
    _close(tlogits.numpy(), logits)
    np.testing.assert_allclose(float(tloss), float(loss), rtol=1e-5)
    assert float(met["ce"]) == float(tloss)
    assert set(ops.launch_counts().values()) == {0}
    if tst is None:
        assert tens is None and tdns is None and tns is None
        return
    got = states_to_reference(tns)
    assert len(jax.tree.leaves(got)) == len(jax.tree.leaves(rns))
    for a, w in zip(jax.tree.leaves(got), jax.tree.leaves(rns)):
        np.testing.assert_allclose(a, w, rtol=0,
                                   atol=3.5e-4 * np.abs(w).max())


@pytest.mark.parametrize("method", ["wsi", "wasi"])
def test_gradients_match_reference(method):
    """The gradient of every leaf (factored L and R, norms, the tied
    embedding) against ``jax.grad`` of the reference's loss; ``wasi``
    through the Tucker residuals, with the cross-attention sites on the
    fused route (no state)."""
    _, tcfg = _cfgs(method)
    params, states, batches = _draws()
    want = _reference_pass(method)[4]
    model = from_reference(params, tcfg, "cpu", trainable=True)
    _, _, grads, _ = value_and_grad(
        ted.encdec_loss, model, _torch_batch(batches[0]), tcfg,
        states_from_reference(states, "cpu") if method == "wasi" else None)
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    names = {".".join(str(getattr(e, "key", e)) for e in path): v
             for path, v in flat}
    assert sorted(names) == sorted(grads)
    for k, g in grads.items():
        w = names[k]
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(), err_msg=k)


# ---------------------------------------------------------------------------
# the slice gate: 4 training steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method,gate", [
    ("wsi", "sgd_momentum"), ("wsi", "adamw"), ("wasi", "sgd_momentum"),
    ("wasi", "adamw")])
def test_training_matches_reference_train_step(method, gate):
    rcfg, tcfg = _cfgs(method)
    params, states, batches = _draws()
    kw = dict(GATES[gate], steps=STEPS, clip_norm=2.0, checkpoint_every=0)
    rtc, ttc = RTrainConfig(**kw), TrainConfig(**kw)
    rstate = rmake_state(KEY, jax.tree.map(jnp.asarray, params), rcfg, rtc,
                         asi_states=(jax.tree.map(jnp.asarray, states)
                                     if method == "wasi" else None))
    state = state_from_reference(jax.tree.map(np.asarray, rstate), tcfg,
                                 "cpu")
    loss = _reference_loss(method)
    rstep = jax.jit(rmake_step(
        lambda p, b, c, states=None, policy=None: loss(p, b, states), rcfg,
        rtc))
    step = make_train_step(ted.encdec_loss, tcfg, ttc)
    ops.reset_launches()
    for i, b in enumerate(batches):
        rstate, rm = rstep(rstate, jax.tree.map(jnp.asarray, b))
        state, m = step(state, _torch_batch(b))
        for k in ("loss", "grad_norm", "lr", "ce"):
            rtol = 1e-4 if k == "grad_norm" else 1e-5
            np.testing.assert_allclose(float(m[k]), float(rm[k]), rtol=rtol,
                                       err_msg=f"step {i} {k}")
    assert set(ops.launch_counts().values()) == {0}
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
    if method == "wasi":
        for a, w in zip(jax.tree.leaves(out["asi"]),
                        jax.tree.leaves(rstate.asi)):
            w = np.asarray(w)
            np.testing.assert_allclose(a, w, rtol=0, atol=ASI_TOL[gate]
                                       * np.abs(w).max())
    else:
        assert out["asi"] is None and rstate.asi is None


# ---------------------------------------------------------------------------
# greedy decoding, the launcher
# ---------------------------------------------------------------------------

def test_greedy_decode_matches_reference():
    """``encode`` once, then 8 greedy ``encdec_decode_step``s from the same
    memory and an f32 cache of 16 positions in both packages."""
    rcfg, tcfg = _cfgs("wsi")
    params, _, batches = _draws()
    model = from_reference(params, tcfg, "cpu")
    frames = batches[0]["frames"][:2]
    mem, _ = red.encode(params, jnp.asarray(frames), rcfg)
    with torch.no_grad():
        tmem, _ = ted.encode(model, torch.tensor(frames), tcfg)
    _close(tmem.numpy(), mem)
    cache = red.init_encdec_cache(rcfg, 2, 16, jnp.float32)
    tcache = ted.init_encdec_cache(tcfg, 2, 16, dtype=torch.float32,
                                   device="cpu")
    step = jax.jit(functools.partial(red.encdec_decode_step, cfg=rcfg))
    tok = np.zeros((2, 1), np.int32)
    ttok = tok.copy()
    ops.reset_launches()
    for pos in range(NEW):
        want, cache = step(params, jnp.asarray(tok), mem, cache, pos)
        with torch.no_grad():
            got, out = ted.encdec_decode_step(
                model, torch.tensor(ttok).long(), tmem, tcache, pos, tcfg)
        assert out is tcache
        want = np.asarray(want)
        _close(got.numpy(), want)
        tok = want.argmax(-1)[:, None].astype(np.int32)
        ttok = got.numpy().argmax(-1)[:, None].astype(np.int32)
        top2 = np.sort(want, -1)[:, -2:]
        tie = top2[:, 1] - top2[:, 0] <= 1e-5 * np.sqrt(np.mean(want ** 2))
        assert np.all((tok == ttok)[:, 0] | tie), pos
        if tie.any():
            break
    assert set(ops.launch_counts().values()) == {0}
    # the self-attention cache holds the steps' K/V, the reference's values
    _close(tcache["kv"].k.numpy(), cache["kv"].k)


def test_launcher_trains_whisper():
    """``python -m repro_torch.launch.train --device cpu --arch
    whisper-tiny``: the smoke config under its own method (``wasi``, ASI
    states from ``init_encdec_states``) on ``SyntheticAudio``."""
    hist = tlaunch.main(["--device", "cpu", "--arch", ARCH, "--steps", "2",
                         "--batch", "2", "--seq", "8"])
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)
    cfg, _, state, _, data = tlaunch.build(
        ARCH, smoke=True, batch=2, seq=8, wasi="wsi", tcfg=TrainConfig(),
        device="cpu")
    assert cfg.family == "encdec" and state.asi is None
    assert isinstance(data, SyntheticAudio) and isinstance(
        state.params, ted.EncoderDecoder)
