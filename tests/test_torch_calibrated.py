"""Epsilon-calibrated ranks (paper Eq. 5-7, App. A.2) against the
reference's, on numpy inputs made from a seed and handed to both packages
(f32):

* ``core/rank_policy.py``: ``epsilon_ranks`` equal; ``perplexity_dp`` the
  same choice and totals on seeded P, M, and both raise on an infeasible
  or non-positive budget; ``gradient_perplexity`` within 1e-6 relative.
* ``core/svd.py``: ``pick_rank`` at the threshold's edge (a spectrum
  whose cumulative explained variance passes eps 1e-4 and 3e-6 on either
  side of a rank) gives the exact rank in both packages and through the
  f64 Gram the card's path takes (``gram_singular_values``, whose values
  match f64 LAPACK within 1e-6 of the largest).
* ``api/plan.py``: ``resolve(cfg, calibration=...)`` from a dense tree and
  from a {site: weight} mapping, on qwen2 and tinyllama smoke, factored
  and project: names, modes, ranks and ASI ranks equal to the reference's,
  with one stack whose two layers pick different ranks (the plan keeps
  the larger); the plan's JSON read by both packages, ``calibrated``
  carried.
* ``api/convert.py`` under a calibrated plan: ``factorize`` gives the
  reference's layouts and the reference's L R within 1e-5 of the
  weight's scale (singular vectors are defined up to sign); ``densify``
  within the reference's sqrt(1 - eps) bound per layer for factored
  sites and exact for project.
"""
import itertools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as rconfigs
import repro.core.rank_policy as rrp
import repro.core.svd as rsvd
import repro.models.lm as rlm
import repro_torch.configs as tconfigs
import repro_torch.core.rank_policy as trp
import repro_torch.core.svd as tsvd
from repro import api as rapi
from repro.api import convert as rconvert
from repro.api.plan import SubspacePlan as RPlan
from repro.api.plan import collect_linear_weights as rcollect
from repro_torch import api as tapi
from repro_torch.api import convert as tconvert
from repro_torch.api.bridge import from_reference
from repro_torch.api.plan import SubspacePlan as TPlan
from repro_torch.api.plan import collect_linear_weights as tcollect

torch.set_num_threads(1)
KEY = jax.random.PRNGKey(0)
EPS = 0.8
FIELDS = ("name", "role", "in_dim", "out_dim", "mode", "rank", "bias",
          "kernel", "asi_ranks")


def _spectrum(rng, o, i, s):
    """(o, i) with the singular values ``s``, rotated by random
    orthonormal bases."""
    n = min(o, i)
    u = np.linalg.qr(rng.standard_normal((o, o)))[0][:, :n]
    v = np.linalg.qr(rng.standard_normal((i, i)))[0][:, :n]
    return ((u * s) @ v.T).astype(np.float32)


def _cfg(pkg, arch, method="wsi", update="factored"):
    import dataclasses
    c = pkg.get_smoke(arch)
    return c.replace(wasi=dataclasses.replace(c.wasi, method=method,
                                              update_mode=update))


# ---------------------------------------------------------------------------
# rank policies
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("align", [1, 8])
def test_epsilon_ranks_match_reference(align):
    rng = np.random.default_rng(3)
    ws = [_spectrum(rng, 48, 32, 0.9 ** np.arange(32)),
          _spectrum(rng, 32, 64, 0.97 ** np.arange(32)),
          rng.standard_normal((40, 40)).astype(np.float32)]
    got = trp.epsilon_ranks([torch.from_numpy(w) for w in ws], EPS, align)
    assert got == rrp.epsilon_ranks([jnp.asarray(w) for w in ws], EPS, align)
    assert len(set(got)) == 3


@pytest.mark.parametrize("delta", [1e-4, -1e-4, 3e-6, -3e-6])
def test_pick_rank_at_the_thresholds_edge(delta):
    """A spectrum whose cumulative explained variance at rank 20 is EPS +
    ``delta``: rank 20 when ``delta`` > 0, 21 when below. 3e-6 is ~50
    f32 ulps of the sum at 0.8, above f32 rounding of a 64-value cumsum
    and of a 64 x 48 SVD."""
    n, k = 48, 20
    e = np.geomspace(1.0, 0.2, n)                       # energies, decaying
    head = e[:k].sum()
    # scale the tail so that head / (head + tail) == EPS + delta
    tail = e[k:] * (head / (EPS + delta) - head) / e[k:].sum()
    s = np.sqrt(np.concatenate([e[:k], tail]))
    w = _spectrum(np.random.default_rng(11), 64, n, s)
    want = k if delta > 0 else k + 1
    got = tsvd.pick_rank(torch.from_numpy(w), EPS)
    assert got == want == rsvd.pick_rank(jnp.asarray(w), EPS)
    gram = tsvd.gram_singular_values(torch.from_numpy(w))
    assert int(tsvd.rank_for_threshold(gram, EPS)) == want
    truth = np.linalg.svd(w.astype(np.float64), compute_uv=False)
    np.testing.assert_allclose(gram.numpy(), truth, rtol=0,
                               atol=1e-6 * truth[0])
    np.testing.assert_allclose(
        tsvd.gram_singular_values(torch.from_numpy(w.T.copy())).numpy(),
        truth, rtol=0, atol=1e-6 * truth[0])


@pytest.mark.parametrize("seed,budget", [(0, 1.8), (1, 2.5), (2, 2.0)])
def test_perplexity_dp_matches_reference(seed, budget):
    rng = np.random.RandomState(seed)
    P = rng.rand(6, 5)
    M = rng.rand(6, 5) * 0.5 + 0.1
    got = trp.perplexity_dp(P, M, budget, bins=1024)
    want = rrp.perplexity_dp(P, M, budget, bins=1024)
    assert got.choice == want.choice
    assert got.total_perplexity == want.total_perplexity
    assert got.total_memory == want.total_memory <= budget + 1e-9
    # near-optimal against brute force (the budget's quantization slack)
    best = min(sum(P[i, j] for i, j in enumerate(c))
               for c in itertools.product(range(5), repeat=6)
               if sum(M[i, j] for i, j in enumerate(c)) <= budget)
    assert got.total_perplexity <= best * 1.05 + 1e-9


def test_perplexity_dp_refuses_what_the_reference_refuses():
    P, M = np.ones((3, 2)), np.ones((3, 2)) * 10
    for budget in (1.0, 0.0):
        with pytest.raises(ValueError):
            rrp.perplexity_dp(P, M, budget=budget)
        with pytest.raises(ValueError):
            trp.perplexity_dp(P, M, budget=budget)


def test_gradient_perplexity_matches_reference():
    rng = np.random.default_rng(5)
    a = rng.standard_normal((3, 16, 8)).astype(np.float32)
    b = a + 1e-2 * rng.standard_normal(a.shape).astype(np.float32)
    got = trp.gradient_perplexity(torch.from_numpy(a), torch.from_numpy(b))
    want = rrp.gradient_perplexity(jnp.asarray(a), jnp.asarray(b))
    assert got == pytest.approx(want, rel=1e-6)
    assert trp.gradient_perplexity(np.ones((3, 4)), np.zeros((3, 4))) == \
        pytest.approx(math.sqrt(12.0))


# ---------------------------------------------------------------------------
# calibrated resolution
# ---------------------------------------------------------------------------

_DENSE: dict = {}


def _dense_tree(arch):
    """The reference's dense (method none) init of ``arch``'s smoke
    config, as numpy, with layer 0 of ``mlp/up`` given a decaying
    spectrum: its explained-variance rank falls below layer 1's random
    matrix, so the two layers of the stack pick different ranks."""
    if arch not in _DENSE:
        rcfg = _cfg(rconfigs, arch, method="none")
        rapi.uninstall(rcfg)
        rapi.install(rapi.resolve(rcfg))
        try:
            tree = jax.tree.map(np.asarray, rlm.init_lm(KEY, rcfg))
        finally:
            rapi.uninstall(rcfg)
        up = tree["groups"][0][0]["mlp"]["up"]["w"]
        o, i = up.shape[-2:]
        up = up.copy()
        up[0] = _spectrum(np.random.default_rng(2), o, i,
                          0.8 ** np.arange(min(o, i)))
        tree["groups"][0][0]["mlp"]["up"]["w"] = up
        _DENSE[arch] = tree
    return _DENSE[arch]


def _specs(plan):
    return [tuple(getattr(s, f) for f in FIELDS) for s in plan.specs]


@pytest.mark.parametrize("update", ["factored", "project"])
@pytest.mark.parametrize("source", ["tree", "mapping"])
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "tinyllama-1.1b"])
def test_calibrated_resolve_matches_reference(arch, source, update):
    tree = _dense_tree(arch)
    method = "wasi" if update == "project" else "wsi"
    rcfg = _cfg(rconfigs, arch, method, update)
    tcfg = _cfg(tconfigs, arch, method, update)
    if source == "tree":
        rcal = jax.tree.map(jnp.asarray, tree)
        tcal = tree      # numpy leaves: the port reads them as they are
    else:
        rcal = {k: jnp.concatenate(v) for k, v in rcollect(tree).items()}
        tcal = {k: torch.from_numpy(np.concatenate(v))
                for k, v in rcollect(tree).items()}
    want = rapi.resolve(rcfg, batch=2, seq=8, calibration=rcal)
    got = tapi.resolve(tcfg, batch=2, seq=8, calibration=tcal)
    assert got.calibrated and want.calibrated
    assert _specs(got) == _specs(want)
    assert {s.mode for s in got.specs} == {update}
    # the stack's two layers pick different ranks; the plan keeps the
    # larger, and the reference agrees layer by layer
    up = torch.from_numpy(tree["groups"][0][0]["mlp"]["up"]["w"])
    per_layer = trp.epsilon_ranks(list(up), EPS, tcfg.wasi.rank_align)
    assert per_layer == rrp.epsilon_ranks(list(jnp.asarray(up.numpy())),
                                          EPS, rcfg.wasi.rank_align)
    assert per_layer[0] < per_layer[1] == got.spec("mlp/up").rank
    static = tapi.resolve(tcfg, batch=2, seq=8)
    assert not static.calibrated
    assert [s.rank for s in static.specs] != [s.rank for s in got.specs]


def test_calibrated_plan_json_crosses_both_ways():
    tree = _dense_tree("tinyllama-1.1b")
    rcfg = _cfg(rconfigs, "tinyllama-1.1b", "wasi", "project")
    tcfg = _cfg(tconfigs, "tinyllama-1.1b", "wasi", "project")
    want = rapi.resolve(rcfg, batch=2, seq=8,
                        calibration=jax.tree.map(jnp.asarray, tree))
    got = tapi.resolve(tcfg, batch=2, seq=8, calibration=from_reference(
        tree, _cfg(tconfigs, "tinyllama-1.1b", "none"), "cpu"))
    from_ref = TPlan.loads(want.dumps())
    assert from_ref.calibrated and from_ref.model == got.model
    assert _specs(from_ref) == _specs(got)
    back = RPlan.loads(got.dumps())
    assert back.calibrated and _specs(back) == _specs(want)
    tj, rj = got.to_json(), want.to_json()
    for sp in tj["specs"] + rj["specs"]:
        sp.pop("bwd_fits_vmem")
    assert tj == rj
    head = got.summary().splitlines()[0]
    assert head == want.summary().splitlines()[0]
    assert head.endswith("(eps-calibrated)")
    assert "eps-calibrated" not in tapi.resolve(tcfg).summary()


# ---------------------------------------------------------------------------
# factorize / densify under a calibrated plan
# ---------------------------------------------------------------------------

def _factor_sites(tree) -> dict:
    """{path: linear dict} of the plan sites of a converted tree, in
    either package's leaves."""
    out = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            if "L" in node:
                out[prefix] = node
                return
            for k, v in node.items():
                walk(v, f"{prefix}/{k}")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{prefix}/{i}")

    walk(tree, "")
    return out


def _port_dense_model(tree, arch):
    tcfg = _cfg(tconfigs, arch, "none")
    tapi.uninstall(tcfg)
    return from_reference(tree, tcfg, "cpu")


@pytest.mark.parametrize("update", ["factored", "project"])
def test_factorize_densify_under_a_calibrated_plan(update):
    arch = "tinyllama-1.1b"
    tree = _dense_tree(arch)
    method = "wasi" if update == "project" else "wsi"
    rcfg = _cfg(rconfigs, arch, method, update)
    tcfg = _cfg(tconfigs, arch, method, update)
    rplan = rapi.resolve(rcfg, calibration=jax.tree.map(jnp.asarray, tree))
    tplan = tapi.resolve(tcfg, calibration=tree)
    dense = _port_dense_model(tree, arch)
    got = tconvert.factorize(dense, tplan)
    want = rconvert.factorize(jax.tree.map(jnp.asarray, tree), rplan)
    gsites, wsites = _factor_sites(got), _factor_sites(want)
    assert gsites.keys() == wsites.keys()
    for path, p in gsites.items():
        q = wsites[path]
        assert sorted(p) == sorted(q), path
        assert p["L"].shape == q["L"].shape, path
        w = np.asarray(q["w"] if "w" in q else q["L"] @ q["R"])
        np.testing.assert_allclose((p["L"] @ p["R"]).numpy(),
                                   np.asarray(q["L"] @ q["R"]), rtol=0,
                                   atol=1e-5 * np.abs(w).max(), err_msg=path)
    back = tconvert.densify(got, tplan)
    orig = tcollect(dense)
    rec = tcollect(back)
    assert orig.keys() == rec.keys()
    bound = math.sqrt(1 - EPS) + 1e-4
    for name in orig:
        w0, w1 = orig[name][0].detach(), rec[name][0]
        if update == "project":
            assert torch.equal(w0, w1), name
            continue
        for j in range(w0.shape[0]):
            rel = torch.linalg.norm(w0[j] - w1[j]) / torch.linalg.norm(w0[j])
            assert rel <= bound, (name, j, float(rel))
    rback = rconvert.densify(want, rplan)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(rback)):
        b = np.asarray(b)
        np.testing.assert_allclose(np.asarray(a), b, rtol=0,
                                   atol=1e-5 * max(np.abs(b).max(), 1e-30))
