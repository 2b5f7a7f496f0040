"""The port's Mamba-1 (falcon-mamba) against the reference's on the CPU,
and plan-bearing checkpoints of both Mamba families crossing between the
packages.

* ``_selective_scan`` against the reference's at several (B, S, d_inner,
  N): two chunks of 128, S not a multiple of 128 (one chunk of S, as the
  reference takes it), ``return_final``, and its gradients against
  ``jax.grad``.
* ``apply_mamba1`` in train, prefill (ragged ``valid_len``) and decode;
  decode against prefill; the ASI state layout.
* falcon-mamba smoke: the plan JSON (smoke and full), the bridge, logits,
  prefill and decode with every cache leaf, padded against exact-length
  prefill, loss and every gradient against ``jax.grad``, the engine's
  greedy tokens against the reference engine.
* f32 and int8 checkpoints of falcon-mamba and zamba2 smoke written by
  either package (``save_checkpoint`` with the plan) and served by both
  packages' ``ServeEngine.from_checkpoint``: the same greedy tokens.
* The new modules import with JAX blocked; the entry points refuse to fall
  back to the CPU.

Tolerances, f32 on both sides. The scan: the port doubles (Hillis-Steele)
where the reference's ``associative_scan`` runs a tree, so products and
sums round in another order, one rounding per level: outputs, final
states and gradients within ``8 eps (log2 Q + 1)`` of their scale, Q the
chunk length (measured: at most 3.1e-7 of the scale at Q = 256, 4.4e-6
allowed). The block and the model: 1e-5 (``SAME``), as for Mamba-2
(``tests/test_torch_mamba.py``), the reference's 1e-4 where the decode
recurrence stands against the chunked scan, gradients within 2e-5 of
their scale.
"""
import dataclasses
import math
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
from repro import api as rapi
from repro.api import convert as rconvert
from repro.checkpoint import save_checkpoint as rsave
from repro_torch import api as tapi
from repro_torch.api import convert as tconvert
from repro_torch.api.bridge import from_reference, to_reference
from repro_torch.api.plan import SubspacePlan as TPlan
from repro_torch.checkpoint import save_checkpoint as tsave
from repro_torch.kernels import ops
from repro_torch.serve import ServeEngine

torch.set_num_threads(1)
SAME = dict(rtol=1e-5, atol=1e-5)
REASSOC = dict(rtol=1e-4, atol=1e-4)
EPS = float(np.finfo(np.float32).eps)
CACHE = 32
ARCH = "falcon-mamba-7b"
ROOT = pathlib.Path(__file__).resolve().parents[1]

# (B, S, d_inner, N): two chunks of 128; ragged S (one chunk of S); a short
# one; three chunks of a narrow state
SCANS = [(2, 256, 16, 8), (1, 200, 8, 4), (2, 37, 8, 4), (1, 384, 4, 2)]


def _scan_tol(s: int) -> float:
    q = 128 if s % 128 == 0 else s
    return 8 * EPS * (math.log2(q) + 1)


def _scan_inputs(b, s, di, n, seed):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((b, s, di)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, di)) - 1)
                  ).astype(np.float32)
    a = -np.exp(0.5 * rng.standard_normal((di, n))).astype(np.float32)
    bm = rng.standard_normal((b, s, n)).astype(np.float32)
    cm = rng.standard_normal((b, s, n)).astype(np.float32)
    d = rng.standard_normal(di).astype(np.float32)
    return u, dt, a, bm, cm, d


def _close(got, want, rel):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("b,s,di,n", SCANS)
def test_selective_scan_matches_reference(b, s, di, n):
    """y, the final state (``return_final``) and the gradients of a
    weighted sum of y with respect to u, dt, A, B, C and D against the
    reference's ``_selective_scan`` and ``jax.grad`` of it."""
    args = _scan_inputs(b, s, di, n, s + di)
    tol = _scan_tol(s)
    want_y, want_h = rmamba._selective_scan(*map(jnp.asarray, args),
                                            return_final=True)
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    got_y, got_h = tmamba._selective_scan(*ts, return_final=True)
    assert got_h.shape == (b, di, n)
    _close(got_y, want_y, tol)
    _close(got_h, want_h, tol)
    w = np.random.default_rng(1).standard_normal((b, s, di)
                                                 ).astype(np.float32)
    want_g = jax.grad(lambda *x: jnp.sum(rmamba._selective_scan(*x) * w),
                      argnums=tuple(range(6)))(*map(jnp.asarray, args))
    y = tmamba._selective_scan(*ts)
    got_g = torch.autograd.grad((y * torch.from_numpy(w)).sum(), ts)
    for name, g, wg in zip("u dt A B C D".split(), got_g, want_g):
        assert np.isfinite(g.numpy()).all(), name
        _close(g, wg, tol)


def _cfgs():
    return rconfigs.get_smoke(ARCH), tconfigs.get_smoke(ARCH)


def _torch_tree(node):
    if isinstance(node, dict):
        return {k: _torch_tree(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_torch_tree(v) for v in node]
    return torch.from_numpy(np.array(node))


@pytest.fixture(scope="module")
def block():
    rcfg, tcfg = _cfgs()
    p = rmamba.init_mamba1(jax.random.PRNGKey(3), rcfg)
    # move the decay, skip and dt bias off their init values, so the
    # comparison sees them
    rng = np.random.default_rng(8)
    p = dict(p, A_log=p["A_log"] + jnp.asarray(
        0.3 * rng.standard_normal(p["A_log"].shape), jnp.float32),
        D=jnp.asarray(rng.standard_normal(p["D"].shape), jnp.float32),
        dt_proj=dict(p["dt_proj"], b=jnp.asarray(
            0.5 * rng.standard_normal(p["dt_proj"]["b"].shape),
            jnp.float32)))
    x = rng.standard_normal((3, 11, rcfg.d_model)).astype(np.float32)
    return rcfg, tcfg, p, _torch_tree(p), x


def _state_pairs(tstate, rstate):
    return [(tstate.ssm, rstate.ssm), (tstate.conv, rstate.conv)]


def test_apply_mamba1_train_prefill_decode_match_reference(block):
    """Train (no state), prefill with ragged ``valid_len`` (the new state
    and conv buffer) and three decode steps from there: outputs and states
    against the reference's, SAME."""
    rcfg, tcfg, p, tp, x = block
    want, _, _ = rmamba.apply_mamba1(p, jnp.asarray(x), rcfg)
    got, st, _ = tmamba.apply_mamba1(tp, torch.from_numpy(x), tcfg)
    assert st is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SAME)
    vl = np.array([11, 4, 7])
    rs = rmamba.init_mamba1_cache(rcfg, 3)
    ts = tmamba.init_mamba1_cache(tcfg, 3, device="cpu")
    want, rs, _ = rmamba.apply_mamba1(p, jnp.asarray(x), rcfg, state=rs,
                                      valid_len=jnp.asarray(vl))
    got, ts, _ = tmamba.apply_mamba1(tp, torch.from_numpy(x), tcfg, state=ts,
                                     valid_len=torch.from_numpy(vl))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SAME)
    for a, b in _state_pairs(ts, rs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **SAME)
    rng = np.random.default_rng(9)
    for step in range(3):
        xt = rng.standard_normal((3, 1, rcfg.d_model)).astype(np.float32)
        want, rs, _ = rmamba.apply_mamba1(p, jnp.asarray(xt), rcfg, state=rs)
        got, ts, _ = tmamba.apply_mamba1(tp, torch.from_numpy(xt), tcfg,
                                         state=ts)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **SAME,
                                   err_msg=f"decode step {step}")
        for a, b in _state_pairs(ts, rs):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **SAME)


def test_mamba1_decode_matches_prefill(block):
    """The port's own property: token-by-token decode from an empty state
    gives the train-mode outputs and the prefill's final state, REASSOC."""
    _, tcfg, _, tp, x = block
    xt = torch.from_numpy(x)
    y_par, _, _ = tmamba.apply_mamba1(tp, xt, tcfg)
    pre = tmamba.init_mamba1_cache(tcfg, 3, device="cpu")
    _, pre, _ = tmamba.apply_mamba1(tp, xt, tcfg, state=pre)
    st = tmamba.init_mamba1_cache(tcfg, 3, device="cpu")
    ys = []
    for t in range(x.shape[1]):
        y_t, st, _ = tmamba.apply_mamba1(tp, xt[:, t:t + 1], tcfg, state=st)
        ys.append(y_t)
    np.testing.assert_allclose(torch.cat(ys, 1).numpy(), y_par.numpy(),
                               **REASSOC)
    for a, b in ((st.ssm, pre.ssm), (st.conv, pre.conv)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **REASSOC)


def test_init_mamba1_and_its_state_layout_match_reference():
    """Params: the reference's keys, shapes and dtypes (``A_log`` the
    same values, log 1..N per channel, within an ulp; ``D`` ones, zero
    biases); ASI
    warm-start states: the same sites and factor shapes."""
    rcfg, tcfg = _cfgs()
    want = rmamba.init_mamba1(jax.random.PRNGKey(0), rcfg, jnp.bfloat16)
    got = tmamba.init_mamba1(tcfg, generator=torch.Generator(),
                             dtype=torch.bfloat16, device="cpu")
    shapes = jax.tree.map(lambda a: (a.shape, str(a.dtype)), want)
    assert {k: ({kk: (tuple(vv.shape), str(vv.dtype).split(".")[1])
                 for kk, vv in v.items()} if isinstance(v, torch.nn.Module)
                else (tuple(v.shape), str(v.dtype).split(".")[1]))
            for k, v in got.items()} == shapes
    for k in ("D", "conv_b"):
        np.testing.assert_array_equal(got[k].float().numpy(),
                                      np.asarray(want[k], np.float32))
    # torch's log and XLA's round some values to neighbouring floats
    np.testing.assert_allclose(got["A_log"].numpy(), np.asarray(want["A_log"]),
                               rtol=EPS, atol=0)
    st_want = jax.eval_shape(
        lambda k: rmamba.init_mamba1_state(k, rcfg, 2, 16),
        jax.random.PRNGKey(0))
    st_got = tmamba.init_mamba1_state(tcfg, 2, 16,
                                      generator=torch.Generator(),
                                      device="cpu")
    assert set(st_got) == set(st_want) == {"in_proj", "x_proj", "out_proj"}
    for k in st_want:
        assert [None if u is None else tuple(u.shape) for u in st_got[k].us] \
            == [None if u is None else tuple(u.shape) for u in st_want[k].us]


@pytest.mark.parametrize("full", [False, True], ids=["smoke", "full"])
def test_plan_json_matches_reference(full):
    """The plan of falcon-mamba (no weights built) equals the reference's
    JSON, but for ``bwd_fits_vmem``, the TPU's VMEM fit rule the port does
    not stamp; at full width the four sites are factored at the
    reference's ranks."""
    get_r, get_t = ((rconfigs.get, tconfigs.get) if full
                    else (rconfigs.get_smoke, tconfigs.get_smoke))
    assert dataclasses.asdict(get_t(ARCH)) == dataclasses.asdict(get_r(ARCH))
    want = rapi.resolve(get_r(ARCH)).to_json()
    got = tapi.resolve(get_t(ARCH)).to_json()
    for sp in want["specs"]:
        sp.pop("bwd_fits_vmem")
    assert all(sp.pop("bwd_fits_vmem") is None for sp in got["specs"])
    assert got == want
    if full:
        dims = {s["name"]: (s["in_dim"], s["out_dim"], s["rank"], s["bias"])
                for s in got["specs"]}
        assert dims == {"ssm/in_proj": (4096, 16384, 1024, False),
                        "ssm/x_proj": (8192, 288, 128, False),
                        "ssm/dt_proj": (256, 8192, 128, True),
                        "ssm/out_proj": (8192, 4096, 1024, False)}


@pytest.fixture(scope="module")
def models():
    rcfg, tcfg = _cfgs()
    rparams = rlm.init_lm(jax.random.PRNGKey(0), rcfg, jnp.float32)
    tree = jax.tree.map(np.asarray, rparams)
    return rcfg, tcfg, rparams, tree, from_reference(tree, tcfg, "cpu")


def test_bridge_round_trip_and_f32_leaves_beside_bf16_weights(models):
    """Every leaf back bit for bit (dt_proj's bias, the f32 ``A_log`` and
    ``D``); a bf16 tree keeps ``A_log`` and ``D`` in f32."""
    _, tcfg, _, tree, model = models
    flat_a, td_a = jax.tree.flatten(tree)
    flat_b, td_b = jax.tree.flatten(to_reference(model))
    assert td_a == td_b
    for a, b in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert "b" in tree["groups"][0][0]["mixer"]["dt_proj"]
    rcfg = rconfigs.get_smoke(ARCH)
    bf = from_reference(jax.tree.map(np.asarray, rlm.init_lm(
        jax.random.PRNGKey(1), rcfg, jnp.bfloat16)), tcfg, "cpu")
    mixer = bf.groups[0][0]["mixer"]
    assert mixer["A_log"].dtype == mixer["D"].dtype == torch.float32
    assert mixer["dt_proj"]["b"].dtype == torch.bfloat16
    assert mixer["x_proj"]["L"].dtype == mixer["conv_w"].dtype \
        == torch.bfloat16


def test_lm_forward_logits(models):
    rcfg, tcfg, rparams, _, model = models
    toks = np.random.default_rng(0).integers(0, rcfg.vocab_size, (2, 13))
    want, *_ = rlm.lm_forward(rparams, jnp.asarray(toks, jnp.int32), rcfg)
    ops.reset_launches()
    got, *_ = tlm.lm_forward(model, torch.from_numpy(toks), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SAME)
    assert set(ops.launch_counts().values()) == {0}


def _cache_pairs(tc, rc):
    out = []
    for tg, rg in zip(tc, rc):
        for t, r in zip(tg, rg):
            assert set(t) == set(r) == {"ssm"}
            out += _state_pairs(t["ssm"], r["ssm"])
    return out


def test_lm_prefill_and_decode_match_reference(models):
    """Prefill with ragged ``valid_len`` (bucket-padded rows), then decode
    at per-slot positions: logits and every cache leaf (states, conv
    buffers) against the reference's, SAME."""
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


def test_padded_prefill_matches_exact_length_prefill(models):
    """A row right-padded with ``valid_len`` leaves the logits and caches
    of its exact-length prefill, SAME; a recycled slot's stale buffers are
    never read."""
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
    for a, b in zip(_tree_leaves(c1), _tree_leaves(c2)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), **SAME)


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


@pytest.mark.parametrize("s,tol", [(12, 2e-5), (140, 1e-4)])
def test_lm_loss_and_gradients_match_jax_grad(models, s, tol):
    """``lm_loss`` and the gradient of every parameter (L, R and dt_proj's
    bias, conv, decay and skip leaves, norms, embedding) against
    ``jax.grad`` of the reference's: loss SAME, each gradient within
    ``tol`` of its own scale: 2e-5 at S = 12, as for Mamba-2; S = 140
    takes the scan's one-chunk rule past 128, 8 doubling levels whose
    rounding differs from the reference's tree, held to the reference's
    1e-4 for a reassociated scan (measured: 2.2e-5)."""
    rcfg, tcfg, rparams, tree, _ = models
    rng = np.random.default_rng(5)
    toks = rng.integers(0, rcfg.vocab_size, (2, s))
    labels = rng.integers(0, rcfg.vocab_size, (2, s))
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
        assert err <= tol * scale, (name, err, scale)


def test_engine_greedy_tokens_match_reference_engine(models):
    """Prompts through two slots (queueing, slot recycling, two buckets):
    both engines' greedy tokens are identical, and the port's engine
    equals its own lockstep ``generate``."""
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


# ---------------------------------------------------------------------------
# plan-bearing checkpoints of both Mamba families, either package writing
# ---------------------------------------------------------------------------

PROMPTS = [[3, 1, 4, 1, 5], [9, 2, 6]]


@pytest.fixture(scope="module")
def ref_params():
    """arch -> the reference's smoke params (numpy) and plan."""
    out = {}
    for arch in ("falcon-mamba-7b", "zamba2-7b"):
        cfg = rconfigs.get_smoke(arch)
        rapi.uninstall(cfg)
        params = jax.tree.map(np.asarray, rlm.init_lm(jax.random.PRNGKey(2),
                                                      cfg, jnp.float32))
        out[arch] = params, rapi.resolve(cfg)
    return out


def _drive(engine):
    reqs = [engine.submit(p, max_new=6) for p in PROMPTS]
    engine.run()
    return [r.tokens for r in reqs]


@pytest.mark.parametrize("writer", ["reference", "port"])
@pytest.mark.parametrize("quant", ["f32", "int8"])
@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-7b"])
def test_checkpoint_serves_the_same_tokens_in_both_packages(
        arch, quant, writer, ref_params, tmp_path):
    """One package saves the smoke params (int8: ``plan.quantized`` ->
    ``convert.quantize``, dt_proj's bias and the f32 mixer leaves riding
    beside the packs) with its plan; both packages'
    ``ServeEngine.from_checkpoint`` serve it with the same greedy tokens
    and an equal plan, and the port's CPU run launches no kernel."""
    params, plan = ref_params[arch]
    if writer == "reference":
        rplan = plan.quantized("int8") if quant == "int8" else plan
        tree = rconvert.quantize(params, rplan) if quant == "int8" \
            else params
        rsave(str(tmp_path), 3, tree, plan=rplan, label="params")
        want_json = rplan.to_json()
    else:
        tplan = TPlan.from_json(plan.to_json())
        if quant == "int8":
            tplan = tplan.quantized("int8")
        tree = _torch_tree(params)
        if quant == "int8":
            tree = tconvert.quantize(tree, tplan)
        tsave(str(tmp_path), 3, tree, plan=tplan, label="params")
        want_json = tplan.to_json()
    cfg = rconfigs.get_smoke(arch)
    rapi.uninstall(cfg)
    try:
        reng = rserve.ServeEngine.from_checkpoint(str(tmp_path), max_slots=2,
                                                  max_cache=16)
        rtoks = _drive(reng)
        assert reng.plan.to_json() == want_json
    finally:
        rapi.uninstall(cfg)
    tcfg = tconfigs.get_smoke(arch)
    tapi.uninstall(tcfg)
    try:
        ops.reset_launches()
        teng = ServeEngine.from_checkpoint(str(tmp_path), device="cpu",
                                           max_slots=2, max_cache=16)
        ttoks = _drive(teng)
        assert set(ops.launch_counts().values()) == {0}
        assert teng.plan.to_json() == want_json
        assert teng.summary()["quantized"] == (quant == "int8")
    finally:
        tapi.uninstall(tcfg)
    assert ttoks == rtoks


# ---------------------------------------------------------------------------
# imports and devices
# ---------------------------------------------------------------------------

def test_falcon_mamba_entry_points_refuse_to_fall_back_to_cpu(monkeypatch):
    _, tcfg = _cfgs()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlm.init_lm(tcfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlm.init_lm_cache(tcfg, 1, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlm.init_lm_states(tcfg, 1, 8)


def test_new_modules_import_with_jax_blocked():
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'repro'):\n"
            "    sys.modules[m] = None\n"
            "import repro_torch.nn.mamba, repro_torch.kernels.ops\n"
            "import repro_torch.configs.falcon_mamba_7b\n"
            "import repro_torch.models.blocks, repro_torch.api.plan\n"
            "from repro_torch import configs\n"
            "assert configs.get('falcon-mamba-7b').n_layers == 64\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
