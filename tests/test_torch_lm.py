"""The port's LM against the reference's on qwen2 smoke: parameters from
``repro.models.lm.init_lm`` carried across by ``repro_torch.api.bridge``.

Tolerance: f32 at the 1e-5 level (rtol = atol = 2e-5 on logits of
magnitude ~1, 1e-5 on cache leaves). Both sides run the same f32 math;
sums are taken in other orders (matmuls, softmax, the two-layer residual
stream), each contributing a few ulps. Prefill and decode are held to each
other within tolerance, never bitwise (ROADMAP.md queue 3)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as rconfigs
import repro.models.lm as rlm
import repro_torch.configs as tconfigs
import repro_torch.models.lm as tlm
from repro_torch.api.bridge import from_reference, to_reference

torch.set_num_threads(1)
TOL = dict(rtol=2e-5, atol=2e-5)
CACHE = 24


@pytest.fixture(scope="module")
def models():
    rcfg = rconfigs.get_smoke("qwen2-0.5b")
    tcfg = tconfigs.get_smoke("qwen2-0.5b")
    rparams = rlm.init_lm(jax.random.PRNGKey(0), rcfg, jnp.float32)
    tree = jax.tree.map(np.asarray, rparams)
    return rcfg, tcfg, rparams, tree, from_reference(tree, tcfg, "cpu")


def _leaves(caches):
    return [t for g in caches for c in g for t in c["kv"]]


def _rleaves(caches):
    return jax.tree.leaves(caches)


def test_bridge_round_trip_is_exact(models):
    _, _, _, tree, model = models
    back = to_reference(model)
    flat_a, td_a = jax.tree.flatten(tree)
    flat_b, td_b = jax.tree.flatten(back)
    assert td_a == td_b
    for a, b in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    # the stacked leading repeat dim is kept
    assert model.groups[0][0]["attn"]["wq"]["L"].shape[0] == 2


def test_bridge_carries_bfloat16_bit_for_bit():
    rcfg = rconfigs.get_smoke("qwen2-0.5b")
    tcfg = tconfigs.get_smoke("qwen2-0.5b")
    tree = jax.tree.map(np.asarray, rlm.init_lm(jax.random.PRNGKey(1), rcfg,
                                                jnp.bfloat16))
    model = from_reference(tree, tcfg, "cpu")
    w = model.groups[0][0]["mlp"]["up"]["L"]
    assert w.dtype == torch.bfloat16
    ref = tree["groups"][0][0]["mlp"]["up"]["L"].astype(np.float32)
    np.testing.assert_array_equal(w.float().numpy(), ref)


def test_lm_forward_logits(models):
    rcfg, tcfg, rparams, _, model = models
    toks = np.random.default_rng(0).integers(0, rcfg.vocab_size, (2, 9))
    want, *_ = rlm.lm_forward(rparams, jnp.asarray(toks, jnp.int32), rcfg)
    got, *_ = tlm.lm_forward(model, torch.from_numpy(toks), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_lm_prefill_last_only_with_valid_len(models):
    rcfg, tcfg, rparams, _, model = models
    toks = np.random.default_rng(1).integers(0, rcfg.vocab_size, (3, 8))
    vl = np.array([8, 3, 5])
    rc = rlm.init_lm_cache(rcfg, 3, CACHE, dtype=jnp.float32)
    want, rc = rlm.lm_prefill(rparams, jnp.asarray(toks, jnp.int32), rcfg,
                              caches=rc, valid_len=jnp.asarray(vl, jnp.int32),
                              last_only=True)
    tc = tlm.init_lm_cache(tcfg, 3, CACHE, dtype=torch.float32, device="cpu")
    got, tc = tlm.lm_prefill(model, torch.from_numpy(toks), tcfg, caches=tc,
                             valid_len=torch.from_numpy(vl), last_only=True)
    assert got.shape == (3, 1, tcfg.padded_vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for a, b in zip(_leaves(tc), _rleaves(rc)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)


def test_lm_decode_step_per_slot_positions(models):
    """Prefill rows of different lengths, then decode a few steps with a
    (B,) position vector, as the serve engine does."""
    rcfg, tcfg, rparams, _, model = models
    rng = np.random.default_rng(2)
    toks = rng.integers(0, rcfg.vocab_size, (3, 6))
    vl = np.array([6, 2, 4])
    rc = rlm.init_lm_cache(rcfg, 3, CACHE, dtype=jnp.float32)
    _, rc = rlm.lm_prefill(rparams, jnp.asarray(toks, jnp.int32), rcfg,
                           caches=rc, valid_len=jnp.asarray(vl, jnp.int32),
                           last_only=True)
    tc = tlm.init_lm_cache(tcfg, 3, CACHE, dtype=torch.float32, device="cpu")
    _, tc = tlm.lm_prefill(model, torch.from_numpy(toks), tcfg, caches=tc,
                           valid_len=torch.from_numpy(vl), last_only=True)
    pos = vl.copy()
    for step in range(4):
        nxt = rng.integers(0, rcfg.vocab_size, (3, 1))
        want, rc = rlm.lm_decode_step(rparams, jnp.asarray(nxt, jnp.int32),
                                      rc, jnp.asarray(pos, jnp.int32), rcfg)
        got, tc = tlm.lm_decode_step(model, torch.from_numpy(nxt), tc,
                                     torch.from_numpy(pos), tcfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                   err_msg=f"step {step}")
        for a, b in zip(_leaves(tc), _rleaves(rc)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-5)
        pos += 1


def test_prefill_matches_scanned_decode_within_tolerance(models):
    """The port's own property: one prefill equals feeding the prompt
    token by token through decode, at f32 tolerance."""
    _, tcfg, _, _, model = models
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (2, 7)))
    c1 = tlm.init_lm_cache(tcfg, 2, CACHE, dtype=torch.float32, device="cpu")
    pre, c1 = tlm.lm_prefill(model, toks, tcfg, caches=c1, last_only=True)
    c2 = tlm.init_lm_cache(tcfg, 2, CACHE, dtype=torch.float32, device="cpu")
    for t in range(7):
        dec, c2 = tlm.lm_decode_step(model, toks[:, t:t + 1], c2, t, tcfg)
    np.testing.assert_allclose(pre[:, 0].numpy(), dec.numpy(), **TOL)
    for a, b in zip(_leaves(c1), _leaves(c2)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-5)
