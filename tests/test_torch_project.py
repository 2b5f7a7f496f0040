"""Project mode's pieces against the reference's, on numpy inputs made
from a seed and handed to both packages (f32):

* ``core/svd.py``: ``rank_for_threshold`` and ``pick_rank`` equal;
  ``truncated_svd`` compared through L R and the singular values (the
  columns of L and rows of R are defined up to sign, and LAPACK builds
  pick other signs), 1e-5 of the scale.
* ``core/wsi.py``: ``wsi_init`` (through L R) and ``wsi_step`` from the
  same (W, L, R), batched over a stack, within 1e-5 of their scale.
* ``core/project.py``: ``init_project_states`` picks the reference's
  paths and ranks, static and by explained variance, over stacked
  layers; ``update_project_states`` equals the reference's.
* ``core/lowrank_linear.py``: ``wasi_matmul_project`` and
  ``wsi_matmul_project_exact`` forward and gradients within 1e-5 of
  their scale, L and R gradients exactly zero, and the bytes saved for
  backward equal to the reference's VJP residuals.
* ``api/bind.py``: ``inject_factors`` and ``extract_project_factors``
  round trips, and ``apply``'s project branch.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as rconfigs
import repro.core.asi as rasi
import repro.core.lowrank_linear as rll
import repro.core.project as rproject
import repro.core.svd as rsvd
import repro.core.wsi as rwsi
import repro.models.vit as rvit
import repro.utils.memprof as rmem
import repro_torch.configs as tconfigs
import repro_torch.core.asi as tasi
import repro_torch.core.lowrank_linear as tll
import repro_torch.core.project as tproject
import repro_torch.core.svd as tsvd
import repro_torch.core.wsi as twsi
import repro_torch.utils.memprof as tmem
from repro import api as rapi
from repro.api import bind as rbind
from repro_torch import api as tapi
from repro_torch.api import bind as tbind
from repro_torch.api.bridge import from_reference, wsi_from_reference

torch.set_num_threads(1)
KEY = jax.random.PRNGKey(0)


def _close(got, want, rel=1e-5):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30))


def _spectrum(rng, o, i, decay):
    """(o, i) with singular values decay ** j, rotated: a spectrum whose
    explained-variance ranks differ by threshold."""
    u = np.linalg.qr(rng.standard_normal((o, o)))[0][:, :min(o, i)]
    v = np.linalg.qr(rng.standard_normal((i, i)))[0][:, :min(o, i)]
    s = decay ** np.arange(min(o, i))
    return ((u * s) @ v.T).astype(np.float32)


# ---------------------------------------------------------------------------
# svd
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("eps", [0.5, 0.8, 0.9, 0.99, 1.0])
@pytest.mark.parametrize("o,i,decay", [(48, 32, 0.9), (32, 64, 0.95),
                                       (40, 40, 1.0)])
def test_rank_pick_matches_reference(eps, o, i, decay):
    rng = np.random.default_rng(o + i)
    w = _spectrum(rng, o, i, decay)
    s = np.linalg.svd(w, compute_uv=False).astype(np.float32)
    assert int(tsvd.rank_for_threshold(torch.from_numpy(s), eps)) == \
        int(rsvd.rank_for_threshold(jnp.asarray(s), eps))
    for align, cap in ((1, None), (8, None), (1, 5)):
        assert tsvd.pick_rank(torch.from_numpy(w), eps, align, cap) == \
            rsvd.pick_rank(jnp.asarray(w), eps, align, cap)
    _close(tsvd.explained_variance(torch.from_numpy(s)),
           rsvd.explained_variance(jnp.asarray(s)))


@pytest.mark.parametrize("lead", [(), (3,)])
def test_truncated_svd_matches_reference_through_its_product(lead):
    rng = np.random.default_rng(7)
    w = rng.standard_normal(lead + (24, 40)).astype(np.float32)
    k = 9
    got = tsvd.truncated_svd(torch.from_numpy(w), k)
    assert got.L.shape == lead + (24, k) and got.R.shape == lead + (k, 40)
    want_lr = []
    for j in range(int(np.prod(lead))):
        f = rsvd.truncated_svd(jnp.asarray(w.reshape(-1, 24, 40)[j]), k)
        want_lr.append(np.asarray(f.L @ f.R))
    _close((got.L @ got.R).reshape(-1, 24, 40), np.stack(want_lr))
    # L carries the singular values, R has orthonormal rows
    s = np.linalg.svd(w, compute_uv=False)[..., :k]
    _close(torch.linalg.vector_norm(got.L, dim=-2), s)
    eye = torch.eye(k).expand(*lead, k, k)
    _close(got.R @ got.R.mT, eye)
    m = torch.from_numpy(w.reshape(-1, 24, 40)[0])
    f0 = rsvd.truncated_svd(jnp.asarray(m.numpy()), k)
    _close(tsvd.svd_approx(m, k), rsvd.svd_approx(jnp.asarray(m.numpy()), k))
    _close(tsvd.reconstruction_rel_error(m, tsvd.truncated_svd(m, k)),
           rsvd.reconstruction_rel_error(jnp.asarray(m.numpy()), f0))


# ---------------------------------------------------------------------------
# wsi
# ---------------------------------------------------------------------------

def test_wsi_init_and_step_match_reference_on_a_stack():
    """``wsi_init`` through L R; ``wsi_step`` from the reference's own
    init (bridged, so the signs agree) against W moved by one update,
    batched over a (3, O, I) stack as ``update_project_states`` runs it."""
    rng = np.random.default_rng(11)
    w = np.stack([_spectrum(rng, 40, 24, 0.9) for _ in range(3)])
    k = 7
    tw = torch.from_numpy(w)
    got = twsi.wsi_init(tw, k)
    want = [rwsi.wsi_init(jnp.asarray(m), k) for m in w]
    _close(got.L @ got.R, np.stack([np.asarray(f.L @ f.R) for f in want]))
    prev = twsi.WSIState(L=torch.tensor(np.stack([np.asarray(f.L)
                                                  for f in want])),
                         R=torch.tensor(np.stack([np.asarray(f.R)
                                                  for f in want])))
    w2 = w + 0.05 * rng.standard_normal(w.shape).astype(np.float32)
    nxt = twsi.wsi_step(torch.from_numpy(w2), prev)
    for j in range(3):
        ref = rwsi.wsi_step(jnp.asarray(w2[j]), want[j])
        _close(nxt.L[j], ref.L)
        _close(nxt.R[j], ref.R)


# ---------------------------------------------------------------------------
# project states
# ---------------------------------------------------------------------------

def _vit(method="wasi", scope="all"):
    import dataclasses

    def m(c):
        return c.replace(wasi=dataclasses.replace(
            c.wasi, method=method, update_mode="project", scope=scope))
    rcfg, tcfg = m(rconfigs.get_smoke("vit-base")), \
        m(tconfigs.get_smoke("vit-base"))
    for api_, cfg in ((rapi, rcfg), (tapi, tcfg)):
        api_.uninstall(cfg)
        api_.install(api_.resolve(cfg, batch=4, seq=17))
    params = rvit.init_vit(KEY, rcfg, 4, 24, 16)
    model = from_reference(jax.tree.map(np.asarray, params), tcfg, "cpu")
    return rcfg, tcfg, params, model


@pytest.mark.parametrize("use_epsilon", [False, True])
@pytest.mark.parametrize("scope", ["all", "mlp"])
def test_init_project_states_match_reference(use_epsilon, scope):
    """The same paths (wasi-scoped dense W's, no patch or head), the same
    rank per path (static, or the max over the stacked layers of the
    explained-variance pick), factors equal through L R; then one
    ``update_project_states`` equal factor for factor from those
    (bridged) states."""
    rcfg, tcfg, params, model = _vit(scope=scope)
    want = rproject.init_project_states(params, rcfg,
                                        use_epsilon=use_epsilon)
    got = tproject.init_project_states(model, tcfg, use_epsilon=use_epsilon)
    assert sorted(got) == sorted(want)
    assert all(p.startswith("blocks/") for p in got)
    assert (scope == "mlp") == all("/mlp/" in p for p in got)
    for p in want:
        assert got[p].L.shape == want[p].L.shape, p
        _close(got[p].L @ got[p].R, np.asarray(want[p].L @ want[p].R))
    ranks = {p: st.L.shape[-1] for p, st in got.items()}
    if use_epsilon:   # explained variance of a random init: high ranks
        assert ranks != {p: 8 for p in ranks}
    moved = jax.tree.map(lambda x: x * 1.01, params)
    want2 = rproject.update_project_states(moved, want)
    got2 = tproject.update_project_states(
        from_reference(jax.tree.map(np.asarray, moved), tcfg, "cpu"),
        wsi_from_reference(want, "cpu"))
    for p in want2:
        _close(got2[p].L, want2[p].L)
        _close(got2[p].R, want2[p].R)


def test_role_of_path_matches_reference():
    paths = ["patch/w", "head/w", "blocks/attn/wq/w", "blocks/mlp/up/w",
             "blocks/mlp/down/w", "groups/0/0/attn/wo/w", "embed/w", "pos",
             "cls", "blocks/ln1/scale", "groups/0/0/mlp/gate/w"]
    assert [tproject.role_of_path(p) for p in paths] == \
        [rproject.role_of_path(p) for p in paths]


# ---------------------------------------------------------------------------
# the project-mode custom gradients
# ---------------------------------------------------------------------------

def _factors(rng, shape, ranks):
    a = rng.standard_normal(shape).astype(np.float32)
    us = [None if r >= d else
          np.linalg.qr(rng.standard_normal((d, r)))[0].astype(np.float32)
          for d, r in zip(shape, ranks)]
    rf = rasi.asi_project(jnp.asarray(a), rasi.ASIState(
        us=tuple(None if u is None else jnp.asarray(u) for u in us)))
    tf = tasi.TuckerFactors(
        core=torch.tensor(np.asarray(rf.core)),
        us=tuple(None if u is None else torch.from_numpy(u) for u in us))
    return a, rf, tf


CASES = [((4, 16, 32), (4, 8, 12)), ((4, 16, 32), (2, 8, 32)),
         ((3, 4, 5, 20), (3, 2, 3, 8))]


@pytest.mark.parametrize("shape,ranks", CASES)
def test_project_gradients_and_saved_bytes_match_reference(shape, ranks):
    """dx through L and R, dW = f_LR(x~, dy) (Tucker) or dy^T x (exact),
    the L and R gradients zero; what each saves is the reference's VJP
    residuals, (x~, L, R) and (x, L, R), to the byte, and never W."""
    rng = np.random.default_rng(sum(shape))
    a, rf, tf = _factors(rng, shape, ranks)
    i, k, o = shape[-1], 6, 10
    w = rng.standard_normal((o, i)).astype(np.float32)
    l_ = rng.standard_normal((o, k)).astype(np.float32)
    r = rng.standard_normal((k, i)).astype(np.float32)
    dy = rng.standard_normal(shape[:-1] + (o,)).astype(np.float32)
    for rfn, tfn in (
            (lambda x, ww, lf, rr: rll.wasi_matmul_project(x, ww, lf, rr, rf),
             lambda x, ww, lf, rr: tll.wasi_matmul_project(x, ww, lf, rr,
                                                           tf)),
            (rll.wsi_matmul_project_exact, tll.wsi_matmul_project_exact)):
        args = [jnp.asarray(t) for t in (a, w, l_, r)]
        y, vjp = jax.vjp(rfn, *args)
        want = (y,) + vjp(jnp.asarray(dy))
        ts = [torch.from_numpy(t).requires_grad_(True) for t in (a, w, l_, r)]
        got = tfn(*ts)
        got.backward(torch.from_numpy(dy))
        for g, ww in zip([got, ts[0].grad, ts[1].grad], want[:3]):
            _close(g, ww)
        for t in ts[2:]:
            assert not t.grad.any()
        rbytes = rmem.measured_residual_bytes(rfn, *args)
        x, wt = torch.from_numpy(a), torch.from_numpy(w)
        tbytes = tmem.measured_residual_bytes(tfn, x, wt,
                                              torch.from_numpy(l_),
                                              torch.from_numpy(r))
        assert (tbytes.total_bytes, tbytes.n_arrays) == \
            (rbytes.total_bytes, rbytes.n_arrays)
        assert wt.untyped_storage().data_ptr() not in tbytes.storages


# ---------------------------------------------------------------------------
# bind: injection, extraction, apply
# ---------------------------------------------------------------------------

def test_inject_and_extract_round_trip_as_the_reference():
    """``inject_factors`` puts each state's (L, R), detached, beside its W
    and shares every other leaf with the model; ``extract_project_factors``
    takes a tree with carried factors apart again, plain trees copied,
    a model stripped in place; both give the reference's paths."""
    rcfg, tcfg, params, model = _vit()
    rst = rproject.init_project_states(params, rcfg)
    tst = wsi_from_reference(rst, "cpu")
    rinj = rbind.inject_factors(params, rst)
    tinj = tbind.inject_factors(model.tree(), tst)
    want = {"/".join(str(getattr(k, "key", k)) for k in p): v for p, v in
            jax.tree_util.tree_flatten_with_path(rinj)[0]}
    got = tproject.flat_paths(tinj)
    assert sorted(got) == sorted(want)
    for p, v in want.items():
        np.testing.assert_array_equal(got[p].detach().numpy(), np.asarray(v))
    assert tinj["blocks"]["mlp"]["up"]["w"] is model.blocks["mlp"]["up"]["w"]
    assert not tinj["blocks"]["mlp"]["up"]["L"].requires_grad
    # a plain tree: copied, factors out
    stripped, warm = tbind.extract_project_factors(tinj)
    rstripped, rwarm = rbind.extract_project_factors(rinj)
    assert sorted(warm) == sorted(rwarm) == sorted(tst)
    assert "L" not in stripped["blocks"]["mlp"]["up"]
    assert "L" in tinj["blocks"]["mlp"]["up"]
    assert sorted(tproject.flat_paths(stripped)) == sorted(
        "/".join(str(getattr(k, "key", k)) for k in p)
        for p, _ in jax.tree_util.tree_flatten_with_path(rstripped)[0])
    # a model carrying factors (a converted checkpoint): stripped in place
    carried = from_reference(jax.tree.map(np.asarray, rinj), tcfg, "cpu")
    back, warm = tbind.extract_project_factors(carried)
    assert back is carried and "L" not in carried.blocks["mlp"]["up"]
    for p in rwarm:
        np.testing.assert_array_equal(warm[p].L.detach().numpy(),
                                      np.asarray(rwarm[p].L))
    assert tbind.extract_project_factors(model) == (model, {})


def test_apply_project_site_matches_reference():
    """One project site through ``bind.apply``: with an ASI state the
    Tucker path (refreshed state returned), without one the exact path;
    outputs within 1e-5 of their scale."""
    rcfg, tcfg, params, _ = _vit()
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 17, 64)).astype(np.float32)
    w = rng.standard_normal((128, 64)).astype(np.float32) * 0.1
    f = rsvd.truncated_svd(jnp.asarray(w), 12)
    rspec = rapi.plan_of(rcfg).spec("mlp/up")
    tspec = tapi.plan_of(tcfg).spec("mlp/up")
    assert tspec.mode == rspec.mode == "project"
    rp = {"w": jnp.asarray(w), "L": f.L, "R": f.R}
    tp = {k: torch.tensor(np.asarray(v)) for k, v in rp.items()}
    st = rbind.asi_state(KEY, (4, 17, 64), rcfg.wasi)
    from repro_torch.api.bridge import states_from_reference
    tst = states_from_reference(jax.tree.map(np.asarray, st), "cpu")
    for rs, ts in ((st, tst), (None, None)):
        want, wst = rbind.apply(rspec, rp, jnp.asarray(x), rcfg.wasi, rs)
        got, gst = tbind.apply(tspec, tp, torch.from_numpy(x), tcfg.wasi, ts)
        _close(got, want)
        assert (gst is None) == (wst is None)
