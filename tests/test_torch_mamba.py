"""The port's Mamba-2 family against the reference's on the CPU: kernel
#8's function (``ref.ssd_scan_ref``, what ``ops.ssd_scan`` runs on a CPU
tensor) against the reference's ``_ssd_chunked`` and its Pallas kernel
``ssd_scan_tiled`` in interpret mode; the card's branch with grad; ``apply_mamba2`` in train, prefill
and decode modes; zamba2 smoke's logits, caches, padded prefill, loss and
gradients; the serve engine's greedy tokens. The same numpy inputs, made
from a seed, go to both packages; parameters cross by ``api.bridge``.

Tolerances, f32 on both sides: 1e-5 where both packages run the same
formula in the same order of chunks (one block, logits and caches of the
whole model; for the scan against ``_ssd_chunked``, 1e-5 of the output's
scale, as its einsums sum up to Q + N terms of magnitude ~10 in another
order); the reference's own
1e-4 where the Pallas kernel or a token-by-token decode reassociates the
scan (``tests/test_kernels.py::test_ssd_scan_kernel``,
``tests/test_prefill.py``); gradients 2e-5 of their scale. The card's
kernel is held to its plain version in ``tests/test_torch_cuda.py`` and
``chip_smoke.py`` phase 16.
"""
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as rconfigs
import repro.models.lm as rlm
import repro.nn.mamba as rmamba
import repro.serve as rserve
import repro_torch.configs as tconfigs
import repro_torch.models.lm as tlm
import repro_torch.nn.mamba as tmamba
from repro.kernels.ssd_scan import ssd_scan_tiled
from repro_torch.api.bridge import from_reference
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd_scan as kssd
from repro_torch.serve import ServeEngine

torch.set_num_threads(1)
SAME = dict(rtol=1e-5, atol=1e-5)
REASSOC = dict(rtol=1e-4, atol=1e-4)
CACHE = 32
ROOT = pathlib.Path(__file__).resolve().parents[1]

# (Bz, S, H, dh, N, chunk): the reference's sweep
# (tests/test_kernels.py::test_ssd_scan_kernel), then ragged S, then a
# state wider than it is tall (N > dh)
SWEEP = [(2, 32, 4, 8, 4, 8), (1, 64, 2, 16, 8, 16), (1, 128, 8, 32, 16, 32)]
RAGGED = [(2, 100, 3, 16, 8, 32), (1, 37, 2, 8, 4, 37), (2, 13, 2, 8, 4, 8)]
WIDE = [(1, 48, 2, 4, 16, 16)]


def _scan_inputs(bz, s, h, dh, n, seed):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((bz, s, h, dh)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((bz, s, h)))).astype(np.float32)
    a = -np.exp(rng.standard_normal(h)).astype(np.float32)
    b = rng.standard_normal((bz, s, n)).astype(np.float32)
    c = rng.standard_normal((bz, s, n)).astype(np.float32)
    return u, dt, a, b, c


@pytest.mark.parametrize("bz,s,h,dh,n,chunk", SWEEP + RAGGED + WIDE)
def test_ssd_scan_ref_matches_reference(bz, s, h, dh, n, chunk):
    """y (without D.u) and the final state against ``_ssd_chunked`` with
    D = 0 (SAME), y against the Pallas kernel in interpret mode where S is
    a chunk multiple (REASSOC, the reference's own tolerance); and
    ``ops.ssd_scan`` on CPU tensors adds D.u and launches nothing."""
    args = _scan_inputs(bz, s, h, dh, n, s + dh)
    got_y, got_s = ref.ssd_scan_ref(*(torch.from_numpy(t) for t in args),
                                    chunk)
    ja = [jnp.asarray(t) for t in args]
    want_y, want_s = rmamba._ssd_chunked(*ja, jnp.zeros((h,)), chunk,
                                         return_final=True)
    assert got_y.shape == (bz, s, h, dh) and got_s.shape == (bz, h, dh, n)
    for got, want in ((got_y, want_y), (got_s, want_s)):
        scale = max(1.0, float(np.abs(np.asarray(want)).max()))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5 * scale)
    if s % chunk == 0:
        tiled = ssd_scan_tiled(*ja, chunk=chunk)
        np.testing.assert_allclose(got_y.numpy(), np.asarray(tiled),
                                   **REASSOC)
    d = np.random.default_rng(1).standard_normal(h).astype(np.float32)
    want = np.asarray(rmamba._ssd_chunked(*ja, jnp.asarray(d), chunk))
    targs = [torch.from_numpy(t) for t in (*args, d)]
    ops.reset_launches()
    y, final = ops.ssd_scan(*targs, chunk, return_final=True)
    np.testing.assert_allclose(y.numpy(), want, rtol=0,
                               atol=1e-5 * max(1.0, np.abs(want).max()))
    np.testing.assert_array_equal(final.numpy(), got_s.numpy())
    assert ops.launch_counts()["ssd_scan"] == 0


def test_ssd_scan_card_path_refuses_grad_and_cpu_tensors(monkeypatch):
    """On the card's branch a scan whose inputs require grad goes through
    ``ops._SSDScan`` (the kernel's forward, a plain chunked backward), so
    it no longer refuses a gradient; the kernel's wrapper still takes
    CUDA tensors only, with grad or without. Shown by sending CPU tensors
    down the card's branch."""
    args = [torch.from_numpy(t) for t in _scan_inputs(1, 16, 2, 8, 4, 0)]
    d = torch.ones(2)
    monkeypatch.setattr(ops, "_on_cpu", lambda t: False)
    u = args[0].clone().requires_grad_(True)
    for scan_args in ((u, *args[1:]), args):
        with pytest.raises(ValueError, match="CUDA tensors only"):
            ops.ssd_scan(*scan_args, d, 8)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        kssd.ssd_scan_cuda(*args, 8)
    assert ops.launch_counts()["ssd_scan"] == 0
    monkeypatch.setattr(ops, "ssd_scan_cuda", ref.ssd_scan_ref)
    y = ops.ssd_scan(u, *args[1:], d, 8)
    assert "_SSDScanBackward" in str(y.grad_fn.next_functions)
    y.sum().backward()
    assert u.grad is not None and torch.isfinite(u.grad).all()


def test_smem_formula_covers_zamba2_chunk():
    assert kssd.smem_bytes(256) == 4 * (64 * 64 + 4 * 64 * 68 + 512)
    assert kssd.smem_bytes(256) <= kssd.SMEM_LIMIT


def _cfgs():
    return rconfigs.get_smoke("zamba2-7b"), tconfigs.get_smoke("zamba2-7b")


def _torch_tree(node):
    if isinstance(node, dict):
        return {k: _torch_tree(v) for k, v in node.items()}
    return torch.tensor(np.asarray(node))


@pytest.fixture(scope="module")
def block():
    rcfg, tcfg = _cfgs()
    p = rmamba.init_mamba2(jax.random.PRNGKey(3), rcfg)
    # move the decay, step bias and skip off their init values, so the
    # comparison sees them
    rng = np.random.default_rng(8)
    nh = p["A_log"].shape[0]
    p = dict(p, A_log=jnp.asarray(rng.standard_normal(nh), jnp.float32) * .5,
             dt_bias=jnp.asarray(rng.standard_normal(nh), jnp.float32) * .5,
             D=jnp.asarray(rng.standard_normal(nh), jnp.float32))
    x = rng.standard_normal((3, 11, rcfg.d_model)).astype(np.float32)
    return rcfg, tcfg, p, _torch_tree(p), x


def _state_pairs(tstate, rstate):
    return [(tstate.ssm, rstate.ssm), (tstate.conv[0], rstate.conv[0]),
            (tstate.conv[1], rstate.conv[1])]


def test_apply_mamba2_train_prefill_decode_match_reference(block):
    """Train (no state), prefill with ragged ``valid_len`` (new SSD state
    and both conv buffers) and three decode steps from there: outputs and
    states against the reference's, SAME."""
    rcfg, tcfg, p, tp, x = block
    want, _, _ = rmamba.apply_mamba2(p, jnp.asarray(x), rcfg)
    got, st, _ = tmamba.apply_mamba2(tp, torch.from_numpy(x), tcfg)
    assert st is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SAME)

    vl = np.array([11, 4, 7])
    rs = rmamba.init_mamba2_cache(rcfg, 3)
    ts = tmamba.init_mamba2_cache(tcfg, 3, device="cpu")
    want, rs, _ = rmamba.apply_mamba2(p, jnp.asarray(x), rcfg, state=rs,
                                      valid_len=jnp.asarray(vl))
    got, ts, _ = tmamba.apply_mamba2(tp, torch.from_numpy(x), tcfg, state=ts,
                                     valid_len=torch.from_numpy(vl))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SAME)
    for a, b in _state_pairs(ts, rs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **SAME)
    rng = np.random.default_rng(9)
    for step in range(3):
        xt = rng.standard_normal((3, 1, rcfg.d_model)).astype(np.float32)
        want, rs, _ = rmamba.apply_mamba2(p, jnp.asarray(xt), rcfg, state=rs)
        got, ts, _ = tmamba.apply_mamba2(tp, torch.from_numpy(xt), tcfg,
                                         state=ts)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **SAME,
                                   err_msg=f"decode step {step}")
        for a, b in _state_pairs(ts, rs):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **SAME)


def test_mamba2_decode_matches_prefill(block):
    """The port's own property: token-by-token decode from an empty state
    gives the train-mode outputs and the prefill's final state, REASSOC
    (the recurrence against the chunked scan)."""
    _, tcfg, _, tp, x = block
    xt = torch.from_numpy(x)
    y_par, _, _ = tmamba.apply_mamba2(tp, xt, tcfg)
    pre_state = tmamba.init_mamba2_cache(tcfg, 3, device="cpu")
    _, pre_state, _ = tmamba.apply_mamba2(tp, xt, tcfg, state=pre_state)
    st = tmamba.init_mamba2_cache(tcfg, 3, device="cpu")
    ys = []
    for t in range(x.shape[1]):
        y_t, st, _ = tmamba.apply_mamba2(tp, xt[:, t:t + 1], tcfg, state=st)
        ys.append(y_t)
    np.testing.assert_allclose(torch.cat(ys, 1).numpy(), y_par.numpy(),
                               **REASSOC)
    for a, b in zip(st.conv + (st.ssm,), pre_state.conv + (pre_state.ssm,)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **REASSOC)


def test_init_mamba2_state_layout_matches_reference():
    """The ASI warm-start states of a Mamba-2 layer: the same sites and
    factor shapes as the reference's (the numbers differ: torch and JAX
    draw different streams)."""
    rcfg, tcfg = _cfgs()
    want = jax.eval_shape(lambda k: rmamba.init_mamba2_state(k, rcfg, 2, 16),
                          jax.random.PRNGKey(0))
    got = tmamba.init_mamba2_state(tcfg, 2, 16,
                                   generator=torch.Generator(),
                                   device="cpu")
    assert set(got) == set(want) == {"in_proj", "bcdt_proj", "out_proj"}
    for k in want:
        assert [None if u is None else tuple(u.shape) for u in got[k].us] \
            == [None if u is None else tuple(u.shape) for u in want[k].us]


@pytest.fixture(scope="module")
def models():
    rcfg, tcfg = _cfgs()
    rparams = rlm.init_lm(jax.random.PRNGKey(0), rcfg, jnp.float32)
    tree = jax.tree.map(np.asarray, rparams)
    return rcfg, tcfg, rparams, tree, from_reference(tree, tcfg, "cpu")


def _cache_pairs(tc, rc):
    """(port leaf, reference leaf) of every cache leaf, by structure."""
    out = []
    for tg, rg in zip(tc, rc):
        for t, r in zip(tg, rg):
            assert set(t) == set(r)
            out += _state_pairs(t["ssm"], r["ssm"])
            if "kv" in t:
                out += [(t["kv"].k, r["kv"].k), (t["kv"].v, r["kv"].v)]
    return out


def test_bridge_round_trip_keeps_every_leaf(models):
    from repro_torch.api.bridge import to_reference

    _, _, _, tree, model = models
    back = to_reference(model)
    flat_a, td_a = jax.tree.flatten(tree)
    flat_b, td_b = jax.tree.flatten(back)
    assert td_a == td_b
    for a, b in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert "shared_attn" in back


def test_bridge_keeps_f32_mixer_leaves_beside_bf16_weights():
    rcfg, tcfg = _cfgs()
    tree = jax.tree.map(np.asarray, rlm.init_lm(jax.random.PRNGKey(1), rcfg,
                                                jnp.bfloat16))
    model = from_reference(tree, tcfg, "cpu")
    mixer = model.groups[0][0]["mixer"]
    assert mixer["A_log"].dtype == torch.float32
    assert mixer["D"].dtype == torch.float32
    assert mixer["in_proj"]["L"].dtype == torch.bfloat16
    assert mixer["conv_w"].dtype == torch.bfloat16
    assert model.shared_attn["attn"]["wq"]["L"].dtype == torch.bfloat16


def test_lm_forward_logits(models):
    rcfg, tcfg, rparams, _, model = models
    toks = np.random.default_rng(0).integers(0, rcfg.vocab_size, (2, 13))
    want, *_ = rlm.lm_forward(rparams, jnp.asarray(toks, jnp.int32), rcfg)
    ops.reset_launches()
    got, *_ = tlm.lm_forward(model, torch.from_numpy(toks), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SAME)
    assert set(ops.launch_counts().values()) == {0}


def test_lm_prefill_and_decode_match_reference(models):
    """Prefill with ragged ``valid_len`` (bucket-padded rows), then decode
    at per-slot positions: logits and every cache leaf (SSD states, conv
    buffers, the shared block's KV) against the reference's, SAME."""
    rcfg, tcfg, rparams, _, model = models
    rng = np.random.default_rng(1)
    toks = rng.integers(0, rcfg.vocab_size, (3, 12))
    vl = np.array([12, 3, 9])
    rc = rlm.init_lm_cache(rcfg, 3, CACHE, dtype=jnp.float32)
    want, rc = rlm.lm_prefill(rparams, jnp.asarray(toks, jnp.int32), rcfg,
                              caches=rc, valid_len=jnp.asarray(vl, jnp.int32),
                              last_only=True)
    tc = tlm.init_lm_cache(tcfg, 3, CACHE, dtype=torch.float32, device="cpu")
    got, tc = tlm.lm_prefill(model, torch.from_numpy(toks), tcfg, caches=tc,
                             valid_len=torch.from_numpy(vl), last_only=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SAME)
    for a, b in _cache_pairs(tc, rc):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **SAME)
    pos = vl.copy()
    for step in range(3):
        nxt = rng.integers(0, rcfg.vocab_size, (3, 1))
        want, rc = rlm.lm_decode_step(rparams, jnp.asarray(nxt, jnp.int32),
                                      rc, jnp.asarray(pos, jnp.int32), rcfg)
        got, tc = tlm.lm_decode_step(model, torch.from_numpy(nxt), tc,
                                     torch.from_numpy(pos), tcfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **SAME,
                                   err_msg=f"step {step}")
        for a, b in _cache_pairs(tc, rc):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **SAME)
        pos += 1


def test_prefill_matches_scanned_decode(models):
    """One prefill against the prompt fed token by token through decode:
    last logits and every cache leaf, REASSOC (the reference's
    tests/test_prefill.py tolerance for the Mamba scan)."""
    _, tcfg, _, _, model = models
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (2, 10)))
    c1 = tlm.init_lm_cache(tcfg, 2, CACHE, dtype=torch.float32, device="cpu")
    pre, c1 = tlm.lm_prefill(model, toks, tcfg, caches=c1, last_only=True)
    c2 = tlm.init_lm_cache(tcfg, 2, CACHE, dtype=torch.float32, device="cpu")
    for t in range(10):
        dec, c2 = tlm.lm_decode_step(model, toks[:, t:t + 1], c2, t, tcfg)
    np.testing.assert_allclose(pre[:, 0].numpy(), dec.numpy(), **REASSOC)
    from repro_torch.serve.engine import _tree_leaves
    for a, b in zip(_tree_leaves(c1), _tree_leaves(c2)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **REASSOC)


def test_padded_prefill_matches_exact_length_prefill(models):
    """A row right-padded to a bucket with ``valid_len`` leaves the same
    logits and caches as its exact-length prefill, SAME; the padding of a
    recycled slot's stale conv buffer is never read."""
    _, tcfg, _, _, model = models
    rng = np.random.default_rng(4)
    prompt = rng.integers(0, 256, (1, 5))
    padded = np.concatenate([prompt, rng.integers(0, 256, (1, 11))], 1)
    c1 = tlm.init_lm_cache(tcfg, 1, CACHE, dtype=torch.float32, device="cpu")
    want, c1 = tlm.lm_prefill(model, torch.from_numpy(prompt), tcfg,
                              caches=c1, last_only=True)
    c2 = tlm.init_lm_cache(tcfg, 1, CACHE, dtype=torch.float32, device="cpu")
    from repro_torch.serve.engine import _tree_leaves
    for leaf in _tree_leaves(c2):
        leaf.normal_()        # a stale slot
    got, c2 = tlm.lm_prefill(model, torch.from_numpy(padded), tcfg,
                             caches=c2, valid_len=torch.tensor([5]),
                             last_only=True)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **SAME)
    for t1, t2 in zip(c1, c2):
        for a, b in zip(t1, t2):
            for x1, x2 in _state_pairs(a["ssm"], b["ssm"]):
                np.testing.assert_allclose(x2.numpy(), x1.numpy(), **SAME)
            if "kv" in a:
                np.testing.assert_allclose(b["kv"].k[:, :, :5].numpy(),
                                           a["kv"].k[:, :, :5].numpy(),
                                           **SAME)


def _flat(node, prefix=""):
    if isinstance(node, dict):
        items = node.items()
    elif isinstance(node, (list, tuple)):
        items = enumerate(node)
    else:
        return {prefix: node}
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def test_lm_loss_and_gradients_match_jax_grad(models):
    """``lm_loss`` and the gradient of every parameter (the mixers' L, R,
    conv, decay, skip and norm leaves, the shared block's) against
    ``jax.grad`` of the reference's ``lm_loss``: loss SAME, each gradient
    within 2e-5 of its own scale."""
    rcfg, tcfg, rparams, tree, _ = models
    rng = np.random.default_rng(5)
    toks = rng.integers(0, rcfg.vocab_size, (2, 12))
    labels = rng.integers(0, rcfg.vocab_size, (2, 12))
    labels[0, :3] = -1
    rb = {"tokens": jnp.asarray(toks, jnp.int32),
          "labels": jnp.asarray(labels, jnp.int32)}
    (want_loss, _), want_g = jax.value_and_grad(
        lambda p: rlm.lm_loss(p, rb, rcfg), has_aux=True)(rparams)
    model = from_reference(tree, tcfg, "cpu", trainable=True)
    loss, _ = tlm.lm_loss(model, {"tokens": torch.from_numpy(toks),
                                  "labels": torch.from_numpy(labels)}, tcfg)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), **SAME)
    want = _flat(jax.tree.map(np.asarray, want_g))
    got = dict(model.named_parameters())
    assert sorted(got) == sorted(want)
    for name, p in got.items():
        w = want[name]
        scale = max(float(np.abs(w).max()), 1e-6)
        err = float(np.abs(p.grad.numpy() - w).max())
        assert err <= 2e-5 * scale, (name, err, scale)


def test_engine_greedy_tokens_match_reference_engine(models):
    """Prompts through two slots (queueing, slot recycling, two buckets):
    the greedy tokens of both engines are identical, and the port's
    engine equals its own lockstep ``generate``."""
    from repro_torch.launch.serve import generate

    rcfg, tcfg, rparams, _, model = models
    rng = np.random.default_rng(7)
    prompts = [list(map(int, rng.integers(0, rcfg.vocab_size, n)))
               for n in (3, 7, 5, 6)]
    kw = dict(max_slots=2, max_cache=32, buckets=(4, 8))
    reng = rserve.ServeEngine(rparams, rcfg, **kw)
    rh = [reng.submit(p, max_new=5) for p in prompts]
    reng.run()
    teng = ServeEngine(model, tcfg, device="cpu", **kw)
    th = [teng.submit(p, max_new=5) for p in prompts]
    teng.run()
    assert [h.tokens for h in th] == [h.tokens for h in rh]
    for p, h in zip(prompts, th):
        want = generate(model, tcfg, torch.tensor([p]), max_cache=32,
                        n_new=5)
        assert h.tokens == want[0].tolist()
    leaves = [t for t in _cache_leaf_kinds(teng.caches)]
    assert teng.cache_bytes() == sum(t.numel() * t.element_size()
                                     for t in leaves)


def _cache_leaf_kinds(caches):
    from repro_torch.serve.engine import _tree_leaves
    leaves = _tree_leaves(caches)
    # per layer: SSD state, two conv buffers, and K, V where the shared
    # block runs
    n_mamba = sum(len(g) for g in caches)
    n_kv = sum(1 for g in caches for c in g if "kv" in c)
    assert len(leaves) == 3 * n_mamba + 2 * n_kv
    return leaves


def test_zamba2_entry_points_refuse_to_fall_back_to_cpu(monkeypatch):
    _, tcfg = _cfgs()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlm.init_lm(tcfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlm.init_lm_cache(tcfg, 1, 8)


def test_new_modules_import_with_jax_blocked():
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'repro'):\n"
            "    sys.modules[m] = None\n"
            "import repro_torch.nn.mamba, repro_torch.kernels.ssd_scan\n"
            "import repro_torch.configs.zamba2_7b, repro_torch.models.blocks\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
