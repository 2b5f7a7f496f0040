"""The port's ASI math (``repro_torch.core.asi``) against the reference's
(``repro.core.asi``), on the same numpy inputs: one warm-started Tucker
compression step, projection onto fixed factors, the shifted-Cholesky
orthogonalization with its ladder, and the weight gradient straight from
Tucker factors (f_LR) on its three paths, 3D and 4D.

Tolerances (f32 on both sides; the same contractions summed in other
orders by XLA and by torch): the Tucker core and the factors of one
``asi_step`` within 1e-5 of their scale (two staged CholeskyQRs of
well-conditioned operands, condition < 1e2, amplify a few ulps by that);
f_LR, a chain of three contractions, within 1e-5 of the result's scale.
The ladder case is ill-conditioned on purpose (shifted Gram condition
~1e4), so there 1e-3 of the scale, the bound phase 6 of chip_smoke.py
holds the CholeskyQR kernel's ladder to.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.asi as rasi
import repro_torch.core.asi as tasi
from repro.api import bind as rbind
from repro.configs.common import SCALE_WASI as RSCALE_WASI
from repro_torch.api import bind as tbind
from repro_torch.configs.common import SCALE_WASI as TSCALE_WASI
from repro_torch.core.orthogonal import shifted_cholesky_ladder

torch.set_num_threads(1)


def _orth(rng, d, r):
    return np.linalg.qr(rng.standard_normal((d, r)))[0].astype(np.float32)


def _states(rng, shape, ranks):
    """The same ASIState in both packages (None where rank >= dim)."""
    us = [None if r >= d else _orth(rng, d, r) for d, r in zip(shape, ranks)]
    rs = rasi.ASIState(us=tuple(None if u is None else jnp.asarray(u)
                                for u in us))
    ts = tasi.ASIState(us=tuple(None if u is None else torch.from_numpy(u)
                                for u in us))
    return rs, ts


def _close(got, want, rel):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30))


def _same_factors(tf, rf, rel):
    _close(tf.core, rf.core, rel)
    assert len(tf.us) == len(rf.us)
    for a, b in zip(tf.us, rf.us):
        assert (a is None) == (b is None)
        if a is not None:
            _close(a, b, rel)


# (activation shape, per-mode ranks): identity batch (the config
# default), full Tucker, an identity token mode, and 4D
CASES = [((4, 16, 32), (4, 8, 12)), ((6, 16, 32), (3, 8, 12)),
         ((4, 16, 32), (4, 16, 12)), ((3, 5, 6, 20), (3, 4, 3, 8)),
         ((3, 5, 6, 20), (2, 4, 3, 8))]


@pytest.mark.parametrize("shape,ranks", CASES)
def test_asi_step_matches_reference(shape, ranks):
    rng = np.random.default_rng(sum(shape))
    a = rng.standard_normal(shape).astype(np.float32)
    rs, ts = _states(rng, shape, ranks)
    rf, rns = rasi.asi_step(jnp.asarray(a), rs)
    tf, tns = tasi.asi_step(torch.from_numpy(a), ts)
    _same_factors(tf, rf, 1e-5)
    assert tns.us == tf.us
    # a second step from the refreshed state: the warm start carries
    rf2, _ = rasi.asi_step(jnp.asarray(a), rns)
    tf2, _ = tasi.asi_step(torch.from_numpy(a), tns)
    _same_factors(tf2, rf2, 1e-5)
    np.testing.assert_allclose(float(tasi.tucker_rel_error(
        torch.from_numpy(a), tf2)), float(rasi.tucker_rel_error(
            jnp.asarray(a), rf2)), rtol=1e-4)


@pytest.mark.parametrize("shape,ranks", CASES[:2])
def test_asi_step_keeps_a_bf16_activation_in_bf16(shape, ranks):
    """The iteration runs in f32; the new factors and the core come back
    in the activation's dtype, as in the reference."""
    rng = np.random.default_rng(7)
    a = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    _, ts = _states(rng, shape, ranks)
    ts = tasi.ASIState(us=tuple(None if u is None else u.bfloat16()
                                for u in ts.us))
    tf, tns = tasi.asi_step(a.bfloat16(), ts)
    assert tf.core.dtype == torch.bfloat16
    assert all(u is None or u.dtype == torch.bfloat16 for u in tns.us)


@pytest.mark.parametrize("shape,ranks", CASES)
def test_asi_project_and_reconstruct_match_reference(shape, ranks):
    rng = np.random.default_rng(3)
    a = rng.standard_normal(shape).astype(np.float32)
    rs, ts = _states(rng, shape, ranks)
    rf = rasi.asi_project(jnp.asarray(a), rs)
    tf = tasi.asi_project(torch.from_numpy(a), ts)
    _same_factors(tf, rf, 1e-6)
    _close(tasi.tucker_reconstruct(tf), rasi.tucker_reconstruct(rf), 1e-6)
    assert tasi.tucker_storage(shape, ranks) == \
        rasi.tucker_storage(shape, ranks)
    assert tasi.compression_ratio(shape, ranks) == \
        rasi.compression_ratio(shape, ranks)


def test_orth_last_matches_reference():
    rng = np.random.default_rng(11)
    v = rng.standard_normal((4, 16, 8)).astype(np.float32)
    got = tasi._orth_last(torch.from_numpy(v))
    _close(got, rasi._orth_last(jnp.asarray(v)), 1e-5)
    g = got.reshape(-1, 8)
    torch.testing.assert_close(g.T @ g, torch.eye(8), rtol=0, atol=1e-5)


def test_orth_last_takes_the_ladder_where_the_first_cholesky_fails():
    """v = U diag(s) V^T with one singular value 1 and the rest 1e-5: the
    Gram's rounding exceeds the first shift, the first factorization fails
    (NaN in JAX, ``info`` in torch) and both take the 1e4-times larger
    shift."""
    rng = np.random.default_rng(13)
    m, r = 512, 32
    u, w = _orth(rng, m, r), _orth(rng, r, r)
    sv = np.full(r, 1e-5, np.float32)
    sv[0] = 1.0
    v = ((u * sv) @ w.T).astype(np.float32).reshape(4, 128, r)
    vt = torch.from_numpy(v)
    _, retried = shifted_cholesky_ladder(tasi._gram_last(vt), 1e-6)
    assert bool(retried)
    want = rasi._orth_last(jnp.asarray(v))
    assert np.isfinite(np.asarray(want)).all()
    got = tasi._orth_last(vt)
    assert torch.isfinite(got).all()
    _close(got, want, 1e-3)


FLR_3D = [((4, 6, 10), (4, 3, 5)),   # identity batch: contract ranks first
          ((4, 6, 10), (4, 6, 5)),   # identity batch and token mode
          ((4, 6, 10), (4, 3, 10)),  # identity batch and feature mode
          ((5, 6, 10), (2, 3, 5)),   # full Tucker: Eqs. 15-18
          ((5, 6, 10), (2, 6, 5))]   # compressed batch, identity token
FLR_4D = [((3, 4, 5, 8), (3, 2, 3, 4)), ((3, 4, 5, 8), (3, 4, 3, 8)),
          ((3, 4, 5, 8), (2, 2, 3, 4)), ((3, 4, 5, 8), (2, 4, 3, 4))]


@pytest.mark.parametrize("shape,ranks", FLR_3D + FLR_4D)
def test_flr_weight_grad_matches_reference(shape, ranks):
    rng = np.random.default_rng(len(shape) * 10 + sum(ranks))
    a = rng.standard_normal(shape).astype(np.float32)
    dy = rng.standard_normal(shape[:-1] + (7,)).astype(np.float32)
    rs, ts = _states(rng, shape, ranks)
    rf = rasi.asi_project(jnp.asarray(a), rs)
    tf = tasi.asi_project(torch.from_numpy(a), ts)
    rfn = rasi.flr_weight_grad_3d if len(shape) == 3 \
        else rasi.flr_weight_grad_4d
    tfn = tasi.flr_weight_grad_3d if len(shape) == 3 \
        else tasi.flr_weight_grad_4d
    got = tfn(tf, torch.from_numpy(dy))
    assert got.shape == (7, shape[-1])
    _close(got, rfn(rf, jnp.asarray(dy)), 1e-5)
    # and equal to the dense product with the reconstructed activation
    dense = torch.tensordot(torch.from_numpy(dy), tasi.tucker_reconstruct(tf),
                            dims=(list(range(len(shape) - 1)),) * 2)
    _close(got, dense.numpy(), 1e-5)


def test_general_flr_path_is_the_reference_fallback():
    """A compressed batch with an identity token mode has no specialized
    reordering: both packages go through ``_flr_general``."""
    rng = np.random.default_rng(5)
    shape, ranks = (5, 6, 10), (2, 6, 5)
    a = rng.standard_normal(shape).astype(np.float32)
    dy = rng.standard_normal((5, 6, 7)).astype(np.float32)
    rs, ts = _states(rng, shape, ranks)
    tf = tasi.asi_project(torch.from_numpy(a), ts)
    assert tf.us[0] is not None and tf.us[1] is None
    _close(tasi._flr_general(tf, torch.from_numpy(dy)),
           rasi._flr_general(rasi.asi_project(jnp.asarray(a), rs),
                             jnp.asarray(dy)), 1e-5)


def test_asi_init_draws_orthonormal_factors_with_identity_modes():
    g = torch.Generator().manual_seed(0)
    st = tasi.asi_init(g, (4, 64, 96), (4, 8, 16), dtype=torch.bfloat16)
    assert st.us[0] is None
    assert [tuple(u.shape) for u in st.us[1:]] == [(64, 8), (96, 16)]
    for u in st.us[1:]:
        assert u.dtype == torch.bfloat16
        uf = u.float()
        torch.testing.assert_close(uf.T @ uf, torch.eye(u.shape[1]),
                                   rtol=0, atol=2e-2)
    again = tasi.asi_init(torch.Generator().manual_seed(0), (4, 64, 96),
                          (4, 8, 16), dtype=torch.bfloat16)
    assert all(torch.equal(a, b) for a, b in zip(st.us[1:], again.us[1:]))


@pytest.mark.parametrize("act", [(4, 512, 896), (4, 512, 4864),
                                 (2, 16, 64)])
def test_site_state_ranks_match_reference(act):
    """``bind.asi_state`` gives each mode the reference's rank: identity
    where the reference keeps full rank, else the same (D, r) factor."""
    import jax

    rst = rbind.asi_state(jax.random.PRNGKey(0), act, RSCALE_WASI)
    tst = tbind.asi_state(torch.Generator().manual_seed(0), act, TSCALE_WASI,
                          device="cpu")
    assert [None if u is None else tuple(u.shape) for u in tst.us] == \
        [None if u is None else tuple(u.shape) for u in rst.us]
