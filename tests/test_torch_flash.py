"""Kernel #7's function, flash attention, against the reference's on the
CPU: the port's ``ops.flash_attention`` (its plain version
``ref.flash_attention_ref`` on a CPU tensor) against the reference's
``ops.flash_attention`` (the Pallas kernel in interpret mode) and its
``dense_attention`` and ``chunked_attention``; ``_FlashAttention``'s
gradient against ``jax.grad`` of ``dense_attention``; the port's
``apply_attention`` (full sequence, and prefill at offset 0, both now
through the flash entry) against the reference's. The same numpy inputs,
made from a seed, go to both packages.

Tolerance: f32 on both sides, atol 2e-5 at unit-normal inputs, outputs
and gradients alike: the online softmax (the Pallas kernel, chunked
attention) against one softmax over all keys, and sums in other orders.
The card's kernel is held to its plain version in
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` phase 13.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as rconfigs
import repro.nn.attention as rattn
import repro_torch.configs as tconfigs
import repro_torch.nn.attention as tattn
from repro import api as rapi
from repro.kernels import ops as rops
from repro_torch import api as tapi
from repro_torch.kernels import ops

torch.set_num_threads(1)
ATOL = 2e-5

# (B, Sq=Sk, H, KVH, dh, causal, window): the reference's sweep
# (tests/test_kernels.py::test_flash_attention_sweep) and ViT's
# bidirectional 197 tokens
SWEEP = [(2, 128, 4, 2, 32, True, 0), (1, 256, 4, 4, 64, True, 64),
         (2, 100, 2, 1, 16, False, 0), (1, 384, 2, 2, 128, True, 128),
         (1, 64, 8, 2, 96, True, 0), (2, 197, 4, 4, 16, False, 0)]


def _qkv(b, s, h, kvh, dh, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, s, n, dh)).astype(np.float32)
                 for n in (h, kvh, kvh))


@pytest.mark.parametrize("b,s,h,kvh,dh,causal,window", SWEEP)
def test_flash_matches_reference_kernel_and_attention(b, s, h, kvh, dh,
                                                     causal, window):
    q, k, v = _qkv(b, s, h, kvh, dh, s + dh)
    ops.reset_launches()
    got = ops.flash_attention(*(torch.from_numpy(t) for t in (q, k, v)),
                              causal=causal, window=window).numpy()
    assert ops.launch_counts()["flash_attention"] == 0     # CPU: plain
    jq, jk, jv = (jnp.asarray(t) for t in (q, k, v))
    for want in (rops.flash_attention(jq, jk, jv, causal=causal,
                                      window=window),
                 rattn.dense_attention(jq, jk, jv, causal=causal,
                                       window=window),
                 rattn.chunked_attention(jq, jk, jv, causal=causal,
                                         window=window, chunk=64,
                                         q_chunk=96)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                                   atol=ATOL)
    # the port's own counterparts of dense_attention and chunked_attention
    tq, tk, tv = (torch.from_numpy(t) for t in (q, k, v))
    for fn in (tattn.dense_attention,
               lambda *a, **kw: tattn.chunked_attention(*a, chunk=64,
                                                        q_chunk=96, **kw)):
        np.testing.assert_allclose(
            got, fn(tq, tk, tv, causal=causal, window=window).numpy(),
            rtol=0, atol=ATOL)


@pytest.mark.parametrize("causal,window,h,kvh", [
    (True, 0, 4, 2), (False, 0, 4, 4), (True, 24, 4, 1), (False, 24, 6, 2)])
def test_flash_gradient_matches_jax_grad_of_dense_attention(causal, window,
                                                            h, kvh):
    """dq, dk, dv of ``_FlashAttention`` (plain f32 recompute; dk, dv summed
    over each KV head's query group) against ``jax.vjp`` of the
    reference's ``dense_attention``."""
    q, k, v = _qkv(2, 57, h, kvh, 16, h * 10 + kvh)
    dy = np.random.default_rng(1).standard_normal(q.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b_, c: rattn.dense_attention(
        a, b_, c, causal=causal, window=window),
        *(jnp.asarray(t) for t in (q, k, v)))
    want = vjp(jnp.asarray(dy))
    ts = [torch.from_numpy(t).requires_grad_(True) for t in (q, k, v)]
    out = ops.flash_attention(*ts, causal=causal, window=window)
    assert out.grad_fn is not None and "FlashAttention" in \
        type(out.grad_fn).__name__
    got = torch.autograd.grad(out, ts, torch.from_numpy(dy))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=ATOL)


def test_flash_saves_only_q_k_v():
    """What the attention core keeps for backward: q, k and v, never the
    (B, H, Sq, Sk) probabilities."""
    from repro_torch.utils.memprof import measured_residual_bytes

    q, k, v = (torch.from_numpy(t) for t in _qkv(2, 64, 4, 2, 16, 0))
    rep = measured_residual_bytes(
        lambda a, b_, c: ops.flash_attention(a, b_, c, causal=True), q, k, v)
    assert rep.total_bytes == 4 * (q.numel() + k.numel() + v.numel())
    dense = measured_residual_bytes(
        lambda a, b_, c: tattn.dense_attention(a, b_, c, causal=True),
        q, k, v)
    assert dense.total_bytes > rep.total_bytes + 4 * 2 * 4 * 64 * 64


@pytest.mark.parametrize("arch,causal", [("qwen2-0.5b", True),
                                         ("vit-base", False)])
def test_apply_attention_matches_reference(arch, causal):
    """The port's ``apply_attention`` with bridged params: a full-sequence
    forward (training, ViT) and, for the decoder, a prefill at offset 0
    that fills a cache, both against the reference's; outputs within
    ATOL of the reference, caches equal to 1e-6."""
    rcfg, tcfg = rconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
    rcfg = rcfg.replace(wasi=dataclasses.replace(rcfg.wasi, method="none"))
    tcfg = tcfg.replace(wasi=dataclasses.replace(tcfg.wasi, method="none"))
    for api_, cfg in ((rapi, rcfg), (tapi, tcfg)):
        api_.uninstall(cfg)
        api_.install(api_.resolve(cfg))
    p = rattn.init_attention(jax.random.PRNGKey(2), rcfg)
    tp = {n: {kk: torch.tensor(np.asarray(vv)) for kk, vv in d.items()}
          for n, d in p.items()}
    x = np.random.default_rng(4).standard_normal(
        (2, 23, rcfg.d_model)).astype(np.float32)
    want, _, _ = rattn.apply_attention(p, jnp.asarray(x), rcfg,
                                       causal=causal)
    ops.reset_launches()
    got, _, _ = tattn.apply_attention(tp, torch.from_numpy(x), tcfg,
                                      causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    if not causal:
        return
    rc = rattn.init_cache(rcfg, 2, 32, dtype=jnp.float32)
    tc = tattn.init_cache(tcfg, 2, 32, dtype=torch.float32, device="cpu")
    want, rc, _ = rattn.apply_attention(p, jnp.asarray(x), rcfg, cache=rc,
                                        pos=0)
    got, tc, _ = tattn.apply_attention(tp, torch.from_numpy(x), tcfg,
                                       cache=tc, pos=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(rc.k), atol=1e-6)
    np.testing.assert_allclose(tc.v.numpy(), np.asarray(rc.v), atol=1e-6)
    assert set(ops.launch_counts().values()) == {0}


@pytest.mark.parametrize("causal,window,h,kvh", [
    (True, 0, 4, 2), (False, 0, 4, 4), (True, 12, 4, 1), (False, 12, 6, 2),
    (True, 0, 2, 2)])
def test_tiled_backward_equals_dense_backward(causal, window, h, kvh):
    """The tiled backward (used above ``DENSE_BWD_MAX`` tokens) with
    ragged 16-row query blocks and 16-key chunks at S = 40 against the
    dense backward: dq, dk, dv at f32 1e-5 (the same f32 math, the softmax
    recomputed per tile, sums in another order)."""
    q, k, v = (torch.from_numpy(t) for t in _qkv(2, 40, h, kvh, 16,
                                                   h + kvh + window))
    do = torch.from_numpy(np.random.default_rng(5).standard_normal(
        q.shape).astype(np.float32))
    want = ops._attention_bwd_dense(q, k, v, do, causal, window)
    for q_tile, kv_tile in ((16, 16), (16, 7), (40, 13)):
        got = ops._attention_bwd_tiled(q, k, v, do, causal, window, q_tile,
                                       kv_tile)
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.dtype == w.dtype
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                       atol=1e-5)


@pytest.mark.parametrize("s,path", [(2048, "dense"), (2049, "tiled")])
def test_flash_backward_picks_dense_up_to_2048_tokens(monkeypatch, s, path):
    """``_FlashAttention`` keeps the dense backward up to 2048 tokens and
    tiles above, as the reference switches to ``chunked_attention``."""
    called = []
    for name in ("dense", "tiled"):
        fn = getattr(ops, f"_attention_bwd_{name}")
        monkeypatch.setattr(
            ops, f"_attention_bwd_{name}",
            lambda *a, _n=name, _f=fn: called.append(_n) or _f(*a))
    assert ops.DENSE_BWD_MAX == 2048 and ops.BWD_TILE == 1024
    q, k, v = (torch.from_numpy(t).requires_grad_(True)
               for t in _qkv(1, s, 1, 1, 8, 3))
    out = ops.flash_attention(q, k, v, causal=True)
    torch.autograd.grad(out.sum(), (q, k, v))
    assert called == [path]
