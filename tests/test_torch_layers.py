"""The port's layers against the reference's JAX functions, on the same
numpy inputs, in f32 on the CPU.

Tolerance: 1e-5 absolute and relative unless a test says otherwise. The
two sides compute the same f32 expressions; only the order of the sums
(reductions over head_dim, d_model or the cache length, all <= 128 here)
and libm's transcendentals differ, each a few f32 ulps."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as rapi
import repro.configs as rconfigs
import repro.nn.attention as ratt
import repro.nn.mlp as rmlp
import repro.nn.norms as rnorms
import repro.nn.rotary as rrot
import jax
from repro_torch.api.bridge import _module
import repro_torch.configs as tconfigs
import repro_torch.nn.attention as tatt
import repro_torch.nn.mlp as tmlp
import repro_torch.nn.norms as tnorms
import repro_torch.nn.rotary as trot

torch.set_num_threads(1)   # tiny ops: one thread is many times faster here
TOL = dict(rtol=1e-5, atol=1e-5)
RNG = np.random.default_rng(0)


def _n(*shape, scale=1.0):
    return (RNG.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norms(kind):
    x, s, b = _n(2, 5, 64), _n(64), _n(64)
    rp = {"scale": jnp.asarray(s), "bias": jnp.asarray(b)}
    tp = {"scale": _t(s), "bias": _t(b)}
    want = rnorms.apply_norm(kind, rp, jnp.asarray(x))
    got = tnorms.apply_norm(kind, tp, _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("pos", ["range", "vector", "scalar"])
def test_apply_rope(pos):
    x = _n(3, 6, 4, 16)
    if pos == "range":
        p = np.arange(6) + 5
    elif pos == "vector":
        p = np.array([[3], [9], [40]])   # (B, 1) per-row positions
        x = x[:, :1]
    else:
        p = np.full((6,), 17)
    want = rrot.apply_rope(jnp.asarray(x), jnp.asarray(p), 1e6)
    got = trot.apply_rope(_t(x), _t(p), 1e6)
    # angles up to 40 rad: sin/cos of them in two libms agree to ~1e-6
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=2e-5)


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_mlp_through_factored_sites(act):
    rcfg = rconfigs.get_smoke("qwen2-0.5b").replace(mlp_act=act)
    tcfg = tconfigs.get_smoke("qwen2-0.5b").replace(mlp_act=act)
    assert rapi.plan_of(rcfg).spec("mlp/up").mode == "factored"
    p = jax.tree.map(np.asarray, rmlp.init_mlp(jax.random.PRNGKey(3), rcfg))
    assert ("gate" in p) == (act == "swiglu")
    x = _n(2, 7, rcfg.d_model)
    want, _ = rmlp.apply_mlp(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                             rcfg)
    got, _ = tmlp.apply_mlp(_module(p, "cpu"), _t(x), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("causal,window,q_offset",
                         [(True, 0, 0), (False, 0, 0), (True, 5, 0),
                          (True, 0, 3)])
def test_dense_attention(causal, window, q_offset):
    q, k, v = _n(2, 9, 4, 16), _n(2, 12, 2, 16), _n(2, 12, 2, 16)
    want = ratt.dense_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal,
                                window=window, q_offset=q_offset)
    got = tatt.dense_attention(_t(q), _t(k), _t(v), causal=causal,
                               window=window, q_offset=q_offset)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("window", [0, 6])
def test_chunked_attention(window):
    q, k, v = _n(2, 21, 4, 16), _n(2, 21, 2, 16), _n(2, 21, 2, 16)
    kw = dict(causal=True, window=window, chunk=8, q_chunk=8)
    want = ratt.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), **kw)
    got = tatt.chunked_attention(_t(q), _t(k), _t(v), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    dense = tatt.dense_attention(_t(q), _t(k), _t(v), causal=True,
                                 window=window)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), **TOL)


def _cache(b=3, s=10):
    return _n(b, s, 2, 16), _n(b, s, 2, 16)


@pytest.mark.parametrize("pos", [7, [2, 9, 5]])
@pytest.mark.parametrize("window", [0, 4, 10])
def test_decode_attention(pos, window):
    k, v = _cache()
    q = _n(3, 1, 4, 16)
    rpos = jnp.asarray(pos, jnp.int32) if isinstance(pos, list) else pos
    tpos = torch.tensor(pos) if isinstance(pos, list) else pos
    want = ratt.decode_attention(jnp.asarray(q), ratt.KVCache(
        jnp.asarray(k), jnp.asarray(v)), rpos, window=window)
    got = tatt.decode_attention(_t(q), tatt.KVCache(_t(k), _t(v)), tpos,
                                window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("pos", [6, [0, 9, 4]])
@pytest.mark.parametrize("window", [0, 10])
def test_cache_update(pos, window):
    k, v = _cache()
    kn, vn = _n(3, 1, 2, 16), _n(3, 1, 2, 16)
    rpos = jnp.asarray(pos, jnp.int32) if isinstance(pos, list) else pos
    tpos = torch.tensor(pos) if isinstance(pos, list) else pos
    want = ratt.cache_update(ratt.KVCache(jnp.asarray(k), jnp.asarray(v)),
                             jnp.asarray(kn), jnp.asarray(vn), rpos,
                             window=window)
    got = tatt.cache_update(tatt.KVCache(_t(k.copy()), _t(v.copy())),
                            _t(kn), _t(vn), tpos, window=window)
    np.testing.assert_array_equal(got.k.numpy(), np.asarray(want.k))
    np.testing.assert_array_equal(got.v.numpy(), np.asarray(want.v))


@pytest.mark.parametrize("valid_len", [None, [7, 3, 1]])
@pytest.mark.parametrize("offset,window,s_cache", [(0, 0, 12), (2, 0, 12),
                                                   (0, 4, 4), (3, 4, 4)])
def test_cache_update_prefill(valid_len, offset, window, s_cache):
    k, v = _cache(s=s_cache)
    kn, vn = _n(3, 7, 2, 16), _n(3, 7, 2, 16)
    rvl = None if valid_len is None else jnp.asarray(valid_len, jnp.int32)
    tvl = None if valid_len is None else torch.tensor(valid_len)
    want = ratt.cache_update_prefill(
        ratt.KVCache(jnp.asarray(k), jnp.asarray(v)), jnp.asarray(kn),
        jnp.asarray(vn), offset, window=window, valid_len=rvl)
    got = tatt.cache_update_prefill(
        tatt.KVCache(_t(k.copy()), _t(v.copy())), _t(kn), _t(vn), offset,
        window=window, valid_len=tvl)
    np.testing.assert_array_equal(got.k.numpy(), np.asarray(want.k))
    np.testing.assert_array_equal(got.v.numpy(), np.asarray(want.v))
