"""Self-speculative decoding: the port's ``serve/sampling.py`` spec helpers,
the dense verify pass (``lm_prefill`` at per-row offsets), the draft views
(``SubspacePlan.with_draft``, ``api.convert.draft_view``) and the spec
engine, against the reference on the same numpy inputs and the same
weights (``api.bridge``).

As the reference's ``tests/test_spec_decode.py`` does, qwen2 smoke is
trained 40 steps in the reference (once, in the module's fixture; under
``wsi``, which compiles faster than the config's ``wasi``) so that no
greedy choice is a near-tie that two summation orders could flip; the
trained weights are carried to the port. Tolerances:

* probabilities (``warped_probs``, a draft's q): atol 2e-6, rtol 1e-5 on
  values of one f32 softmax computed in another order; the filters'
  zero patterns are compared exactly;
* logits and caches of the verify pass: rtol = atol = 2e-5, the f32
  tolerance of ``tests/test_torch_lm.py`` (sums in another order);
* tokens, accept counts and the greedy emissions: exact;
* the sampled rejection rule, by distribution (torch's generators are not
  JAX's): the TV distance and the two-sample chi-square per degree of
  freedom of ``tests/test_spec_decode.py``, with its hot-temperature
  negative control.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as rconfigs
import repro.models.lm as rlm
import repro.serve as rserve
import repro.serve.sampling as rsamp
import repro_torch.configs as tconfigs
import repro_torch.models.lm as tlm
import repro_torch.serve.sampling as tsamp
from repro import api as rapi
from repro.config import TrainConfig
from repro.data.synthetic import SyntheticLM
from repro.train.step import make_train_state, make_train_step
from repro_torch import api as tapi
from repro_torch.api import convert as tconvert
from repro_torch.api.bridge import from_reference
from repro_torch.launch import serve as tlaunch
from repro_torch.serve import ServeEngine

torch.set_num_threads(1)
MAX_CACHE, MAX_NEW = 32, 10
ENGINE_KW = dict(max_slots=2, max_cache=MAX_CACHE, buckets=(4, 8, 16))
PAGED_KW = dict(paged=True, page_size=8, prefill_chunk=8)
PROB_TOL = dict(rtol=1e-5, atol=2e-6)
TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(scope="module")
def world():
    """qwen2 smoke trained 40 steps in the reference (its spec tests'
    recipe, under wsi) and the reference's init it started from, the
    port's models of the same weights, three prompts and the reference's
    non-spec greedy tokens for them under either weights."""
    rcfg = rconfigs.get_smoke("qwen2-0.5b")
    cfg = tconfigs.get_smoke("qwen2-0.5b")
    # trained under wsi (factored, no ASI states): the same factored
    # layout the config serves, at two thirds of the compile time
    wcfg = rcfg.replace(wasi=dataclasses.replace(rcfg.wasi, method="wsi"))
    rapi.uninstall(wcfg)
    key = jax.random.PRNGKey(0)
    params = rlm.init_lm(key, wcfg, jnp.dtype(rcfg.dtype))
    tc = TrainConfig(optimizer="sgd", lr=0.3, momentum=0.9,
                     checkpoint_every=0)
    state = make_train_state(key, params, wcfg, tc)
    jstep = jax.jit(make_train_step(rlm.lm_loss, wcfg, tc))
    data = SyntheticLM(vocab_size=rcfg.vocab_size, seq_len=32,
                       global_batch=8, seed=1)
    for i in range(40):
        state, _ = jstep(state, data.batch(i))
    rapi.uninstall(wcfg)
    rapi.uninstall(rcfg)
    rparams = state.params
    rng = np.random.default_rng(7)
    prompts = [list(map(int, rng.integers(0, cfg.vocab_size, n)))
               for n in (3, 7, 12)]
    models, baselines = {}, {}
    for name, tree in (("trained", rparams), ("init", params)):
        tapi.uninstall(cfg)
        models[name] = from_reference(jax.tree.map(np.asarray, tree), cfg,
                                      "cpu")
        reng = rserve.ServeEngine(tree, rcfg, **ENGINE_KW)
        hs = [reng.submit(p, max_new=MAX_NEW) for p in prompts]
        reng.run()
        rapi.uninstall(rcfg)
        baselines[name] = [h.generated for h in hs]
    return types.SimpleNamespace(rcfg=rcfg, cfg=cfg, rparams=rparams,
                                 model=models["trained"], models=models,
                                 prompts=prompts,
                                 baseline=baselines["trained"],
                                 baselines=baselines)


def _engine(world, model=None, **kw):
    tapi.uninstall(world.cfg)
    return ServeEngine(model or world.model, world.cfg, device="cpu",
                       **{**ENGINE_KW, **kw})


def _generate(eng, prompts, sampling=None):
    hs = [eng.submit(p, max_new=MAX_NEW, sampling=sampling) for p in prompts]
    eng.run()
    return [h.generated for h in hs], hs


# ---------------------------------------------------------------------------
# sampling: warped_probs, sample_draft_tokens, spec_accept
# ---------------------------------------------------------------------------

V = 64
# rows: greedy, temperature only, top-k, top-p, all three, hot
PARAMS = dict(temperature=np.array([0.0, 0.7, 1.0, 1.3, 0.9, 3.0],
                                   np.float32),
              top_k=np.array([0, 0, 5, 0, 8, 0], np.int32),
              top_p=np.array([1.0, 1.0, 1.0, 0.8, 0.9, 1.0], np.float32))


def _logits(shape, seed):
    return np.random.default_rng(seed).normal(0, 2.0, shape).astype(
        np.float32)


def _jparams(**kw):
    return {k: jnp.asarray(v) for k, v in kw.items()}


def test_warped_probs_matches_reference():
    lg = _logits((6, V), 0)
    want = np.asarray(rsamp.warped_probs(jnp.asarray(lg),
                                         **_jparams(**PARAMS)))
    got = tsamp.warped_probs(torch.from_numpy(lg), **PARAMS).numpy()
    assert ((got > 0) == (want > 0)).all()
    np.testing.assert_allclose(got, want, **PROB_TOL)
    # (B, k+1, V) rows with per-row parameters broadcast over positions:
    # one sort, the same values as row by row
    lg3 = _logits((6, 3, V), 1)
    rep = {k: np.repeat(v[:, None], 3, axis=1) for k, v in PARAMS.items()}
    got3 = tsamp.warped_probs(torch.from_numpy(lg3), **rep).numpy()
    for i in range(3):
        want_i = np.asarray(rsamp.warped_probs(jnp.asarray(lg3[:, i]),
                                               **_jparams(**PARAMS)))
        np.testing.assert_allclose(got3[:, i], want_i, **PROB_TOL)


def test_sample_draft_tokens_greedy_rows_and_q():
    lg = _logits((6, V), 2)
    seeds = np.arange(6, dtype=np.uint32)
    counts = np.arange(6, dtype=np.int32) + 3
    want_t, want_q = rsamp.sample_draft_tokens(
        jnp.asarray(lg), **_jparams(**PARAMS), seeds=jnp.asarray(seeds),
        counts=jnp.asarray(counts))
    got_t, got_q = tsamp.sample_draft_tokens(
        torch.from_numpy(lg), **PARAMS, seeds=seeds, counts=counts)
    # the greedy row proposes argmax in both; every row's q is the warp
    assert int(got_t[0]) == int(want_t[0]) == int(lg[0].argmax())
    np.testing.assert_allclose(got_q.numpy(), np.asarray(want_q),
                               **PROB_TOL)
    # a sampled proposal never has zero probability under its q
    q = got_q.numpy()
    assert all(q[b, int(got_t[b])] > 0 for b in range(6))
    # an all-greedy batch: argmax proposals, q their one-hots, as in JAX
    zero = dict(PARAMS, temperature=np.zeros(6, np.float32))
    want_t, want_q = rsamp.sample_draft_tokens(
        jnp.asarray(lg), **_jparams(**zero), seeds=jnp.asarray(seeds),
        counts=jnp.asarray(counts))
    got_t, got_q = tsamp.sample_draft_tokens(
        torch.from_numpy(lg), **zero, seeds=seeds, counts=counts)
    assert got_t.tolist() == np.asarray(want_t).tolist()
    assert (got_q.numpy() == np.asarray(want_q)).all()


def _accept_inputs(b, k, seed):
    rng = np.random.default_rng(seed)
    target = _logits((b, k + 1, V), seed)
    # drafts that agree with the target's argmax for a random prefix
    toks = target[:, :k].argmax(-1)
    cut = rng.integers(0, k + 1, b)
    for r in range(b):
        toks[r, cut[r]:] = rng.integers(0, V, k - cut[r])
    q = np.array(jax.nn.softmax(_logits((b, k, V), seed + 1), axis=-1))
    dlen = rng.integers(0, k + 1, b).astype(np.int32)
    return target, toks.astype(np.int32), q, dlen


@pytest.mark.parametrize("k", [1, 4])
def test_spec_accept_greedy_rows_exact(k):
    """All-greedy batches (the skip-every-sort path) and the greedy rows of
    a mixed batch: n_acc and the emitted tokens equal the reference's."""
    b = 6
    target, toks, q, dlen = _accept_inputs(b, k, 10 + k)
    seeds = np.arange(b, dtype=np.uint32)
    counts = np.full(b, 2, np.int32)
    for temps in (np.zeros(b, np.float32), PARAMS["temperature"]):
        params = dict(PARAMS, temperature=temps)
        want_n, want_out = rsamp.spec_accept(
            jnp.asarray(target), jnp.asarray(toks), jnp.asarray(q),
            jnp.asarray(dlen), **_jparams(**params),
            seeds=jnp.asarray(seeds), counts=jnp.asarray(counts))
        got_n, got_out = tsamp.spec_accept(
            torch.from_numpy(target), torch.from_numpy(toks).long(),
            torch.from_numpy(q), dlen, **params, seeds=seeds, counts=counts)
        greedy = temps <= 0
        assert (got_n.numpy()[greedy] == np.asarray(want_n)[greedy]).all()
        assert (got_out.numpy()[greedy]
                == np.asarray(want_out)[greedy]).all()
        # a greedy row emits the target's argmaxes
        assert (got_out.numpy()[greedy]
                == target.argmax(-1)[greedy]).all()


def _tv(a, b, v):
    ca = np.bincount(a, minlength=v) / len(a)
    cb = np.bincount(b, minlength=v) / len(b)
    return 0.5 * np.abs(ca - cb).sum()


def _chi2_per_dof(a, b):
    """Two-sample Pearson chi-square per degree of freedom over the union
    support, cells under 5 pooled (``tests/test_spec_decode.py``'s)."""
    support = sorted(set(a.tolist()) | set(b.tolist()))
    na = np.array([(a == t).sum() for t in support], np.float64)
    nb = np.array([(b == t).sum() for t in support], np.float64)
    keep = (na + nb) >= 5
    na = np.append(na[keep], na[~keep].sum())
    nb = np.append(nb[keep], nb[~keep].sum())
    tot = na + nb
    ea = tot * len(a) / (len(a) + len(b))
    eb = tot * len(b) / (len(a) + len(b))
    ok = tot > 0
    stat = ((na[ok] - ea[ok]) ** 2 / ea[ok]
            + (nb[ok] - eb[ok]) ** 2 / eb[ok]).sum()
    return stat / max(int(ok.sum()) - 1, 1)


def _first_tokens(target, draft, temperature, n, k=3):
    """The first token spec_accept emits for ``n`` seeds, the drafts drawn
    from the draft logits by ``sample_draft_tokens`` (so q is their true
    proposal distribution), top-k 8."""
    seeds = np.arange(n, dtype=np.int64) + 1000
    counts = np.full(n, 5, np.int64)
    t = np.full(n, temperature, np.float32)
    tk = np.full(n, 0 if temperature > 2 else 8, np.int64)
    tp = np.ones(n, np.float32)
    toks, qs = [], []
    for i in range(k):
        dl = torch.from_numpy(np.repeat(draft[i][None], n, axis=0))
        tok, q = tsamp.sample_draft_tokens(dl, t, tk, tp, seeds, counts + i)
        toks.append(tok)
        qs.append(q)
    _, out = tsamp.spec_accept(
        torch.from_numpy(np.repeat(target[None], n, axis=0)),
        torch.stack(toks, 1), torch.stack(qs, 1), np.full(n, k), t, tk, tp,
        seeds, counts)
    return out[:, 0].numpy()


def test_spec_accept_sampled_rows_follow_p():
    """Over 2,000 seeds the first emitted token of fixed target logits p
    and draft logits q follows p (at temperature 0.9, top-k 8): as close to
    p's own draws as two independent sets of p's draws are to each other,
    by TV distance (bar: that self-distance + 0.08) and chi-square per
    degree of freedom (< 3). At temperature 3 (no top-k) it must fail the
    same chi-square bar: the harness can tell distributions apart."""
    n = 2000
    rng = np.random.default_rng(3)
    target = _logits((4, V), 30)
    draft = target[:3] + rng.normal(0, 1.0, (3, V)).astype(np.float32)
    p0 = np.asarray(rsamp.warped_probs(
        jnp.asarray(target[:1]), jnp.asarray([0.9], jnp.float32),
        jnp.asarray([8], jnp.int32), jnp.asarray([1.0], jnp.float32)))[0]
    p0 = p0.astype(np.float64)
    p0 /= p0.sum()
    ref = rng.choice(V, n, p=p0)
    ref2 = rng.choice(V, n, p=p0)
    spec = _first_tokens(target, draft, 0.9, n)
    self_tv = _tv(ref, ref2, V)
    assert _tv(spec, ref, V) <= self_tv + 0.08, (_tv(spec, ref, V), self_tv)
    assert _chi2_per_dof(spec, ref) < 3.0, _chi2_per_dof(spec, ref)
    hot = _first_tokens(target, draft, 3.0, n)
    assert _chi2_per_dof(hot, ref) > 3.0, _chi2_per_dof(hot, ref)


def test_spec_seeds_are_distinct_streams():
    """Each salt's stream differs from the non-spec draws and from the
    other salts' at the same (seed, index); the CPU generator, which keeps
    32 bits of a seed, still sees the request's seed."""
    seeds = {tsamp.draw_seed(7, 3)} | {
        tsamp.spec_seed(7, 3, s) for s in (tsamp.SALT_DRAFT,
                                           tsamp.SALT_ACCEPT,
                                           tsamp.SALT_FIX)}
    assert len(seeds) == 4
    assert len({s & 0xFFFFFFFF for s in seeds}) == 4
    assert (tsamp.draw_seed(1, 5) & 0xFFFFFFFF) != \
        (tsamp.draw_seed(2, 5) & 0xFFFFFFFF)
    with pytest.raises(ValueError):
        tsamp.spec_seed(7, 1 << 30, tsamp.SALT_FIX)


# ---------------------------------------------------------------------------
# the dense verify pass
# ---------------------------------------------------------------------------

def test_lm_prefill_verify_matches_reference(world):
    """Three rows at their own positions (one near the cache's end, whose
    block runs past it) and draft lengths: the logits of every position
    and the caches agree with the reference's, and each row's positions
    past its ``valid_len`` keep what they held."""
    cfg, rcfg = world.cfg, world.rcfg
    s_cache, c = 16, 4
    rng = np.random.default_rng(11)
    prompt = rng.integers(0, cfg.vocab_size, (3, 14))
    block = rng.integers(0, cfg.vocab_size, (3, c))
    pos = np.array([5, 9, 14])
    vlen = np.array([4, 2, 1])
    rc = rlm.init_lm_cache(rcfg, 3, s_cache, dtype=jnp.float32)
    _, rc = rlm.lm_prefill(world.rparams, jnp.asarray(prompt), rcfg,
                           caches=rc)
    want, rc = rlm.lm_prefill(world.rparams, jnp.asarray(block), rcfg,
                              caches=rc, pos=jnp.asarray(pos, jnp.int32),
                              valid_len=jnp.asarray(vlen, jnp.int32))
    tc = tlm.init_lm_cache(cfg, 3, s_cache, dtype=torch.float32,
                           device="cpu")
    with torch.inference_mode():
        tlm.lm_prefill(world.model, torch.from_numpy(prompt), cfg, caches=tc)
        before = [t.clone() for t in _kv(tc)]
        got, tc = tlm.lm_prefill(world.model, torch.from_numpy(block), cfg,
                                 caches=tc, pos=torch.from_numpy(pos),
                                 valid_len=torch.from_numpy(vlen))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for a, b, old in zip(_kv(tc), jax.tree.leaves(rc), before):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
        for r in range(3):
            untouched = [j for j in range(s_cache)
                         if not pos[r] <= j < pos[r] + vlen[r]]
            assert torch.equal(a[:, r, untouched], old[:, r, untouched])


def _kv(caches):
    return [t for g in caches for layer in g for t in layer["kv"]]


# ---------------------------------------------------------------------------
# draft views
# ---------------------------------------------------------------------------

def _int8(world):
    """The int8 deployment of the world's model and its plan (installed
    while the model is built, as ``from_reference`` checks the layout
    against the installed plan)."""
    cfg = world.cfg
    tapi.uninstall(cfg)
    qplan = tapi.install(tapi.resolve(cfg).quantized("int8"))
    qmodel = from_reference(tconvert.quantize(world.model, qplan), cfg,
                            "cpu")
    tapi.uninstall(cfg)
    return qmodel, qplan


def test_with_draft_stamps_match_reference(world):
    rplan = rapi.resolve(world.rcfg)
    tplan = tapi.resolve(world.cfg)
    for src in ("int8", "rank:0.5", "rank:0.1"):
        assert [s.draft for s in tplan.with_draft(src).specs] == \
            [s.draft for s in rplan.with_draft(src).specs]
        assert tplan.with_draft(src).draft_source == \
            rplan.with_draft(src).draft_source
        assert "draft=" in tplan.with_draft(src).summary()
    assert tplan.draft_source is None
    for bad in ("rank:0.0", "rank:1.5", "fp4"):
        with pytest.raises(ValueError):
            tplan.with_draft(bad)


def test_draft_view_shares_storage_or_quantizes(world):
    """``rank:0.5`` gives frozen views of the target's factors (same
    storage, L with the full rank's row stride, R's leading rows); ``int8``
    gives exactly ``convert.quantize``'s packs, and an int8 target's rank
    draft slices its int8 factors and the matching sR."""
    cfg, model = world.cfg, world.model
    plan = tapi.resolve(cfg)
    rank = tconvert.draft_view(model, plan.with_draft("rank:0.5"))
    assert rank.embed is model.embed
    for gi, grp in enumerate(model.groups):
        for pi, blk in enumerate(grp):
            for part in ("attn", "mlp"):
                for name, p in blk[part].items():
                    d = rank.groups[gi][pi][part][name]
                    k = p["L"].shape[-1] // 2
                    for key, full, view in (("L", p["L"], d["L"]),
                                            ("R", p["R"], d["R"])):
                        assert view.untyped_storage().data_ptr() == \
                            full.untyped_storage().data_ptr(), key
                        assert not view.requires_grad
                    assert d["L"].stride() == p["L"].stride()
                    assert torch.equal(d["L"], p["L"][..., :k])
                    assert torch.equal(d["R"], p["R"][..., :k, :])
                    assert d["b"] is p["b"] if "b" in p else True
    q8 = tconvert.draft_view(model, plan.with_draft("int8"))
    want = tconvert.quantize(model, plan.quantized("int8"))
    for gi, grp in enumerate(q8.groups):
        for pi, blk in enumerate(grp):
            for part in ("attn", "mlp"):
                for name, p in blk[part].items():
                    w = want["groups"][gi][pi][part][name]
                    assert sorted(p.keys()) == sorted(w.keys())
                    for key in w:
                        assert torch.equal(p[key], w[key]), (name, key)
    qmodel, qplan = _int8(world)
    qrank = tconvert.draft_view(qmodel, qplan.with_draft("rank:0.5"))
    p = qmodel.groups[0][0]["attn"]["wq"]
    d = qrank.groups[0][0]["attn"]["wq"]
    k = p["L"].shape[-1] // 2
    assert torch.equal(d["sR"], p["sR"][..., :k]) and d["sL"] is p["sL"]
    assert d["L"].dtype == torch.int8 and d["L"].stride() == p["L"].stride()


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("draft", ["int8", "rank:0.5"])
@pytest.mark.parametrize("mode", ["dense", "paged"])
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("weights", ["trained", "init"])
def test_spec_greedy_equals_reference_engine(world, weights, draft, mode,
                                             k):
    """The port's spec engine emits the reference's non-spec greedy tokens
    exactly, for either draft, either layout and k of 1 and 3 (3 leaves a
    partial last block); the per-request accept counts add up to the
    engine's, and a paged pool ends audited and empty. The trained weights
    (wide margins) repeat one token, which both drafts mostly guess; the
    weights they were trained from (the reference's init, whose greedy
    tokens the port's non-spec engine already matches) keep the rank
    draft's guesses mostly rejected, so the rejection path runs too."""
    kw = dict(spec_k=k, draft=draft, **(PAGED_KW if mode == "paged" else {}))
    eng = _engine(world, world.models[weights], **kw)
    out, hs = _generate(eng, world.prompts)
    assert out == world.baselines[weights], (draft, mode, k)
    s = eng.summary()
    assert s["spec_steps"] > 0 and s["spec_k"] == k
    assert s["draft_source"] == draft
    assert sum(sum(h.accepted_counts) for h in hs) == \
        s["spec_accepted_tokens"]
    assert all(0.0 <= h.acceptance_rate <= 1.0 for h in hs)
    assert (s["draft_extra_bytes"] > 0) == (draft == "int8")
    if mode == "paged":
        eng.check_invariants()
        eng.release_prefix_cache()
        assert eng.pool.pages_in_use == 0


def test_spec_midstream_admission_and_sampled_mates(world):
    """A request admitted mid-flight drafts at another position in the
    same ticks, and a sampled request shares them: the greedy ones still
    emit the reference's tokens; a starved paged pool shrinks drafts."""
    eng = _engine(world, spec_k=4, draft="int8")
    h0 = eng.submit(world.prompts[0], max_new=MAX_NEW)
    eng.step()
    eng.step()
    h1 = eng.submit(world.prompts[2], max_new=MAX_NEW)
    hs = eng.submit(world.prompts[1], sampling=tsamp.SamplingParams(
        max_new=MAX_NEW, temperature=0.9, top_k=8, seed=3))
    eng.run()
    assert h0.generated == world.baseline[0]
    assert h1.generated == world.baseline[2]
    assert len(hs.generated) == MAX_NEW
    # budgets that end on a page boundary (3 + 5, 7 + 9 tokens: 1 and 2
    # pages of 8) fill a 3-page pool, so the last ticks' verify blocks,
    # which run up to 4 positions past the budget, find no page
    starved = _engine(world, spec_k=4, draft="rank:0.5", total_pages=4,
                      **PAGED_KW)
    hs = [starved.submit(p, max_new=n)
          for p, n in zip(world.prompts[:2], (5, 9))]
    starved.run()
    assert [h.generated for h in hs] == [world.baseline[0][:5],
                                         world.baseline[1][:9]]
    assert starved.stats["spec_page_shrinks"] > 0
    starved.check_invariants()
    starved.release_prefix_cache()
    assert starved.pool.pages_in_use == 0


def test_spec_refusals(world):
    cfg, model = world.cfg, world.model
    with pytest.raises(ValueError, match="spec_k"):
        _engine(world, spec_k=MAX_CACHE - 1)
    for bad in ("rank:0.0", "fp4"):
        with pytest.raises(ValueError):
            _engine(world, spec_k=2, draft=bad)
    qmodel, qplan = _int8(world)
    with pytest.raises(ValueError, match="rank"):
        ServeEngine(qmodel, plan=qplan, device="cpu", spec_k=2,
                    draft="int8", **ENGINE_KW)
    # a rank slice of the resident int8 factors serves
    tapi.uninstall(cfg)
    eng = ServeEngine(qmodel, plan=qplan, device="cpu", spec_k=2,
                      draft="rank:0.5", **ENGINE_KW)
    h = eng.submit(world.prompts[0], max_new=6)
    eng.run()
    assert len(h.generated) == 6 and eng.stats["spec_steps"] > 0
    # a plan with no factored site: a rank draft has nothing to slice
    dcfg = cfg.replace(wasi=dataclasses.replace(cfg.wasi, method="none"))
    tapi.uninstall(dcfg)
    dense = tlm.init_lm(dcfg, device="cpu", seed=0)
    with pytest.raises(ValueError, match="stamps no site"):
        ServeEngine(dense, dcfg, device="cpu", spec_k=2, draft="rank:0.5",
                    **ENGINE_KW)
    tapi.uninstall(dcfg)
    # caches that cannot roll back: sliding-window layers
    gcfg = tconfigs.get_smoke("gemma3-4b")
    tapi.uninstall(gcfg)
    gemma = tlm.init_lm(gcfg, device="cpu", seed=0)
    with pytest.raises(ValueError, match="roll back"):
        ServeEngine(gemma, gcfg, device="cpu", spec_k=2, **ENGINE_KW)
    tapi.uninstall(gcfg)
    with pytest.raises(NotImplementedError):
        _engine(world, spec_k=2, mesh=object())
    # tenant adapters are ported; with spec_k they are the reference's
    # refusal
    with pytest.raises(ValueError, match="mutually exclusive"):
        _engine(world, spec_k=2, adapters=object())
    tapi.uninstall(cfg)


def test_spec_kv_rollback_matches_never_drafted(world):
    """After a full generation, the spec engine's dense cache equals a
    never-drafted engine's over every position the final state says is
    valid (0..pos-1): the verify writes each accepted position's target
    K/V, and rejected positions lie at >= pos, written over before they
    are read. The reference holds this bit for bit (and fails it on some
    hosts); here the verify's (B, k+1)-row products sum in another order
    than a decode step's one row, so the cache is held at the f32
    tolerance. The control, whose verify's cache writes are undone (the
    int8 draft's K/V left where it drafted), must fall outside it."""
    def run(spec_k, undo_verify=False):
        kw = dict(max_slots=1)
        if spec_k:
            kw.update(spec_k=spec_k, draft="int8")
        eng = _engine(world, **kw)
        if undo_verify:
            verify = eng._verify

            def undone(*a, **kw):
                kept = [t.clone() for t in _kv(eng.caches)]
                out = verify(*a, **kw)
                for t, k in zip(_kv(eng.caches), kept):
                    t.copy_(k)
                return out

            eng._verify = undone
        h = eng.submit(world.prompts[2], max_new=6)
        eng.run()
        return eng, h

    ref_eng, ref_h = run(0)
    spec_eng, spec_h = run(3)        # 3 does not divide 6
    assert spec_h.generated == ref_h.generated
    valid = int(ref_eng.pos[0])
    assert valid == int(spec_eng.pos[0])
    for a, b in zip(_kv(ref_eng.caches), _kv(spec_eng.caches)):
        np.testing.assert_allclose(b[:, 0, :valid].numpy(),
                                   a[:, 0, :valid].numpy(), **TOL)
    ctl_eng, ctl_h = run(3, undo_verify=True)
    same = next((j for j, (u, v) in enumerate(zip(ref_h.generated,
                                                  ctl_h.generated))
                 if u != v), len(ctl_h.generated))
    lo = len(world.prompts[2])
    hi = lo + min(same, len(ctl_h.generated) - 1)
    assert hi > lo
    assert not all(np.allclose(b[:, 0, lo:hi].numpy(), a[:, 0, lo:hi].numpy(),
                               **TOL)
                   for a, b in zip(_kv(ref_eng.caches), _kv(ctl_eng.caches)))


def test_serve_launcher_spec_flags(capsys):
    s = tlaunch.main(["--device", "cpu", "--batch", "3", "--max-slots", "2",
                      "--tokens", "5", "--spec-k", "2", "--draft",
                      "rank:0.5", "--paged", "--page-size", "8",
                      "--prefill-chunk", "8"])
    out = capsys.readouterr().out
    assert "[serve] spec k=2 draft=rank:0.5" in out
    assert s["spec_steps"] > 0 and s["completed"] == 3
