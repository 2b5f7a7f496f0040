"""Grouped-query attention: dense and chunked (online-softmax) attention,
one-token decode attention, full and rolling KV caches. Port of
``repro.nn.attention``.

Shapes are the reference's: hidden (B, S, d); heads (B, S, H, Dh); GQA
repeats each of the KVH key/value heads over G = H // KVH query heads by a
reshape.

Every attention over a full sequence from position 0 (training, a
forward without caches, ViT's bidirectional blocks, and the prefill at
offset 0) goes through ``kernels.ops.flash_attention``: the flash kernel
on the card, its plain version on the CPU. The reference runs
``dense_attention`` there up to ``chunked_threshold`` tokens and
``chunked_attention`` above; the kernel computes the same function at
every length. A prefill at an offset > 0 keeps the reference's choice
(the kernel has no query offset), and decode keeps ``decode_attention``.
``dense_attention`` and ``chunked_attention`` stay as the counterparts of
the reference's functions.

Differences from the reference, deliberate:

* Cache writes are IN PLACE (slice assignment / indexed assignment) where
  the reference rebuilt arrays. ``cache_update``/``cache_update_prefill``
  return the same :class:`KVCache` they were given, its tensors updated.
  A scalar write position must lie inside the cache (JAX would clamp it).
* ``chunked_attention`` is a Python loop over query blocks and KV chunks
  in place of ``lax.map``/``lax.scan`` (no remat: serving has no backward).
* Paged writes make every index safe BEFORE they index: JAX fills an
  out-of-range gather and drops an out-of-range scatter, while torch
  raises on the CPU and, on the card, a device-side assert kills the
  CUDA context. A position past the page table goes to the trash page 0
  (see ``_page_ids``), where the reference drops it; every other page
  receives exactly the reference's writes.
* The paged branches attend plainly (gathered pages, a masked softmax),
  as the reference's do: kernel #7 has no query offset and no page table.
* The speculative-verify and cross-attention branches of
  ``apply_attention`` are not ported yet and raise.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from repro_torch.api import bind, plan_of, role_treated
from repro_torch.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.nn.rotary import apply_rope

NEG_INF = -1e30


class KVCache(NamedTuple):
    k: torch.Tensor  # (B, S_cache, KVH, Dh)
    v: torch.Tensor  # (B, S_cache, KVH, Dh)


class PagedKVCache(NamedTuple):
    """Pooled KV storage: pages instead of per-slot rows.

    The batch dimension is gone: storage is a pool of ``n_pages`` pages of
    ``page_size`` token slots each, shared by every serve slot. A per-slot
    ``page_table`` (B, pages_per_slot) maps logical page j of slot b to a
    physical page; reads gather the table into a (B, S_logical) view,
    writes scatter through it. Page 0 is the engine's trash page (dead and
    still-prefilling rows point their table there), so the pool needs no
    per-row validity flags: a position is readable iff the causal mask
    says so, exactly as with dense caches."""

    k: torch.Tensor  # (n_pages, page_size, KVH, Dh)
    v: torch.Tensor  # (n_pages, page_size, KVH, Dh)

    @property
    def page_size(self) -> int:
        return self.k.shape[1]


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------

def init_attention(cfg: ModelConfig, *, generator: torch.Generator,
                   lead: tuple[int, ...] = (), dtype=torch.float32,
                   device=None) -> nn.ModuleDict:
    d, h, kvh, dh = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                     cfg.resolved_head_dim)
    plan = plan_of(cfg)
    qb = cfg.qkv_bias
    kw = dict(generator=generator, lead=lead, dtype=dtype, device=device)
    return nn.ModuleDict({
        "wq": bind.init_params(plan.linear("attn/wq", d, h * dh), bias=qb,
                               **kw),
        "wk": bind.init_params(plan.linear("attn/wk", d, kvh * dh), bias=qb,
                               **kw),
        "wv": bind.init_params(plan.linear("attn/wv", d, kvh * dh), bias=qb,
                               **kw),
        "wo": bind.init_params(
            plan.linear("attn/wo", h * dh, d),
            scale=(h * dh) ** -0.5 / max(cfg.total_pattern_layers, 1) ** 0.5,
            **kw),
    })


def init_attention_state(cfg: ModelConfig, batch: int, seq: int, *,
                         generator: torch.Generator, dtype=torch.float32,
                         device=None) -> dict:
    """ASI warm-start states for the four projections (train path); {}
    when the plan leaves attention's activations dense."""
    d, h, dh = cfg.d_model, cfg.n_heads, cfg.resolved_head_dim
    w = cfg.wasi
    if not (w.compress_acts and role_treated(w, "attn")):
        return {}
    kw = dict(dtype=dtype, device=device)
    return {
        "wq": bind.asi_state(generator, (batch, seq, d), w, **kw),
        "wk": bind.asi_state(generator, (batch, seq, d), w, **kw),
        "wv": bind.asi_state(generator, (batch, seq, d), w, **kw),
        "wo": bind.asi_state(generator, (batch, seq, h * dh), w, **kw),
    }


# ---------------------------------------------------------------------------
# Core attention math
# ---------------------------------------------------------------------------

def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q (B,Sq,KVH,G,Dh) x k (B,Sk,KVH,Dh) -> (B,KVH,G,Sq,Sk)."""
    return torch.einsum("bqhgd,bkhd->bhgqk", q, k)


def _gqa_combine(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """p (B,KVH,G,Sq,Sk) x v (B,Sk,KVH,Dh) -> (B,Sq,KVH,G,Dh)."""
    return torch.einsum("bhgqk,bkhd->bqhgd", p, v)


def _mask_bias(sq: int, sk: int, q_offset, *, causal: bool, window: int,
               device=None) -> torch.Tensor:
    """Additive mask (Sq, Sk). q position = q_offset + row index."""
    qpos = q_offset + torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(sk, device=device)[None, :]
    ok = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        ok &= kpos <= qpos
    if window > 0:
        ok &= kpos > qpos - window
    return torch.where(ok, 0.0, NEG_INF).float()


def dense_attention(q, k, v, *, causal: bool, window: int = 0,
                    q_offset=0) -> torch.Tensor:
    """Reference attention materializing scores. q (B,Sq,H,Dh)."""
    b, sq, h, dh = q.shape
    kvh = k.shape[2]
    g = h // kvh
    qg = q.reshape(b, sq, kvh, g, dh) * (dh ** -0.5)
    s = _gqa_scores(qg, k).float()
    s = s + _mask_bias(sq, k.shape[1], q_offset, causal=causal,
                       window=window, device=q.device)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return _gqa_combine(p, v).reshape(b, sq, h, dh)


def chunked_attention(q, k, v, *, causal: bool, window: int = 0,
                      q_offset=0, chunk: int = 1024,
                      q_chunk: int = 1024) -> torch.Tensor:
    """Online-softmax attention tiled over query blocks and KV chunks
    (flash semantics, plain PyTorch): live scores O(q_chunk * chunk)."""
    b, sq, h, dh = q.shape
    if sq > q_chunk:
        outs = [chunked_attention(q[:, s0:s0 + q_chunk], k, v, causal=causal,
                                  window=window, q_offset=q_offset + s0,
                                  chunk=chunk, q_chunk=q_chunk)
                for s0 in range(0, sq, q_chunk)]
        return torch.cat(outs, dim=1)
    sk, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    qg = (q.reshape(b, sq, kvh, g, dh) * (dh ** -0.5)).to(q.dtype)
    qpos = q_offset + torch.arange(sq, device=q.device)
    m = torch.full((b, kvh, g, sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, kvh, g, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, kvh, g, sq, dh), dtype=torch.float32,
                      device=q.device)
    for c0 in range(0, sk, chunk):
        kb, vb = k[:, c0:c0 + chunk], v[:, c0:c0 + chunk]
        n = kb.shape[1]
        if n < chunk:  # the reference zero-pads the last chunk and masks it
            pad = (0, 0, 0, 0, 0, chunk - n)
            kb = torch.nn.functional.pad(kb, pad)
            vb = torch.nn.functional.pad(vb, pad)
        s = _gqa_scores(qg, kb).float()                 # (B,KVH,G,Sq,chunk)
        kpos = c0 + torch.arange(chunk, device=q.device)
        ok = torch.ones((sq, chunk), dtype=torch.bool, device=q.device)
        if causal:
            ok &= kpos[None, :] <= qpos[:, None]
        if window > 0:
            ok &= kpos[None, :] > qpos[:, None] - window
        ok &= (kpos < sk)[None, :]
        s = s + torch.where(ok, 0.0, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        scale_old = torch.exp(m - m_new)
        l = l * scale_old + p.sum(dim=-1)
        acc = acc * scale_old[..., None] + torch.einsum(
            "bhgqk,bkhd->bhgqd", p.to(q.dtype), vb).float()
        m = m_new
    o = acc / torch.clamp(l[..., None], min=1e-30)
    o = o.reshape(b, kvh * g, sq, dh).transpose(1, 2)
    return o.to(q.dtype)


# ---------------------------------------------------------------------------
# KV caches
# ---------------------------------------------------------------------------

def _rolling_slot_positions(pos: torch.Tensor, w: int) -> torch.Tensor:
    """Absolute position held by each of the W slots when the writer is at
    absolute position ``pos`` (already written); negative if unwritten."""
    slots = torch.arange(w, device=pos.device)
    return pos - torch.remainder(pos - slots, w)


def is_vector_pos(pos) -> bool:
    """Per-slot (B,) vector vs a single shared scalar position."""
    return isinstance(pos, torch.Tensor) and pos.dim() == 1


def init_cache(cfg: ModelConfig, batch: int, seq: int, *, window: int = 0,
               lead: tuple[int, ...] = (), dtype=torch.bfloat16,
               device=None) -> KVCache:
    kvh, dh = cfg.n_kv_heads, cfg.resolved_head_dim
    s = min(seq, window) if window > 0 else seq
    shape = (*lead, batch, s, kvh, dh)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


def init_paged_cache(cfg: ModelConfig, n_pages: int, page_size: int, *,
                     lead: tuple[int, ...] = (), dtype=torch.bfloat16,
                     device=None) -> PagedKVCache:
    """Pooled KV storage for one layer (``lead``: the group's stacked
    ``repeat``): ``n_pages`` pages shared by every serve slot
    (serve/kvpool.py owns the page accounting)."""
    kvh, dh = cfg.n_kv_heads, cfg.resolved_head_dim
    shape = (*lead, n_pages, page_size, kvh, dh)
    return PagedKVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                        v=torch.zeros(shape, dtype=dtype, device=device))


def decode_attention(q, cache: KVCache, pos, *, window: int = 0):
    """Single-token decode. q (B,1,H,Dh); the cache holds positions <= pos.
    ``pos`` is an int (lockstep batch) or a (B,) tensor of per-row
    positions (continuous batching)."""
    b, _, h, dh = q.shape
    s_cache, kvh = cache.k.shape[1], cache.k.shape[2]
    g = h // kvh
    qg = q.reshape(b, 1, kvh, g, dh) * (dh ** -0.5)
    s = _gqa_scores(qg, cache.k).float()                # (B,KVH,G,1,S)
    if is_vector_pos(pos):
        posb = pos.to(q.device)[:, None]
    else:
        posb = torch.full((1, 1), int(pos), device=q.device)
    if window > 0 and s_cache == window:
        ok = _rolling_slot_positions(posb, window) >= 0
    else:
        kpos = torch.arange(s_cache, device=q.device)[None, :]
        ok = kpos <= posb
        if window > 0:
            ok &= kpos > posb - window
    s = s + torch.where(ok, 0.0, NEG_INF)[:, None, None, None, :]
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return _gqa_combine(p, cache.v).reshape(b, 1, h, dh)


def cache_update(cache: KVCache, k_new, v_new, pos, *,
                 window: int = 0) -> KVCache:
    """Write one token's K/V at ``pos`` (rolling if cache len == window),
    in place. ``pos`` an int or (B,) per-row positions."""
    s_cache = cache.k.shape[1]
    rolling = window > 0 and s_cache == window
    if is_vector_pos(pos):
        slot = torch.remainder(pos, window) if rolling else pos
        rows = torch.arange(cache.k.shape[0], device=cache.k.device)
        slot = slot.to(cache.k.device)
        cache.k[rows, slot] = k_new[:, 0]
        cache.v[rows, slot] = v_new[:, 0]
        return cache
    slot = int(pos) % window if rolling else int(pos)
    n = k_new.shape[1]
    cache.k[:, slot:slot + n] = k_new
    cache.v[:, slot:slot + n] = v_new
    return cache


def cache_update_prefill(cache: KVCache, k_new, v_new, offset: int = 0, *,
                         window: int = 0, valid_len=None) -> KVCache:
    """Write a whole prompt's K/V (S tokens from absolute position
    ``offset``) in one pass, in place. ``valid_len`` (B,) marks per-row
    true prompt lengths of right-padded prefill: positions >= valid_len
    are not written, so the cache equals an exact-length prefill's."""
    s_cache = cache.k.shape[1]
    b, s = k_new.shape[:2]
    dev = cache.k.device
    if window > 0 and s_cache == window:
        # slot j holds the LAST valid position p with p % W == j
        end = torch.full((b,), offset + s, device=dev)
        if valid_len is not None:
            end = torch.minimum(end, valid_len.to(dev))
        last = end - 1
        slots = torch.arange(window, device=dev)[None, :]
        owner = last[:, None] - torch.remainder(last[:, None] - slots, window)
        take = torch.clamp(owner - offset, 0, s - 1)
        idx = take[..., None, None].expand(-1, -1, *k_new.shape[2:])
        kg = torch.gather(k_new, 1, idx)
        vg = torch.gather(v_new, 1, idx)
        write = (owner >= offset)[..., None, None]
        cache.k.copy_(torch.where(write, kg, cache.k))
        cache.v.copy_(torch.where(write, vg, cache.v))
        return cache
    kd, vd = cache.k[:, offset:offset + s], cache.v[:, offset:offset + s]
    if valid_len is not None:
        pos_abs = offset + torch.arange(s, device=dev)
        valid = (pos_abs[None, :] < valid_len.to(dev)[:, None])[..., None,
                                                                  None]
        k_new = torch.where(valid, k_new, kd)
        v_new = torch.where(valid, v_new, vd)
    kd.copy_(k_new)
    vd.copy_(v_new)
    return cache


# ---------------------------------------------------------------------------
# Paged gather / scatter / attention
# ---------------------------------------------------------------------------

def paged_gather(pool: torch.Tensor, page_table: torch.Tensor
                 ) -> torch.Tensor:
    """(n_pages, PG, KVH, Dh) pool + (B, P) table -> (B, P*PG, KVH, Dh)
    per-slot logical view. Positions no page was written at hold whatever
    the physical page last held; every read below masks by position, so
    such slots get a softmax weight of exactly zero. Every table entry is
    a page id, so the gather is always in range."""
    g = pool[page_table.long()]                   # (B, P, PG, KVH, Dh)
    b, p, pg = g.shape[:3]
    return g.reshape(b, p * pg, *g.shape[3:])


def _page_ids(page_table: torch.Tensor, pos: torch.Tensor, page_size: int,
              valid=None) -> torch.Tensor:
    """Physical page under each absolute position ``pos`` (B, C) of a
    row, made safe BEFORE it indexes. Two kinds of position lie past the
    row's table:

    * dead rows keep their stale ``pos``, which equals ``max_cache`` after
      a request that used its whole budget, so ``pos // page_size`` equals
      ``pages_per_slot``;
    * the padded rows of a prefill chunk sit past ``end``, and so past the
      engine's ``n_hist``-sliced table.

    The reference gathers first (JAX fills an out-of-range index, and its
    scatter then drops the write) and routes ``valid_len``'s padding to
    page 0 after. Torch would raise, or assert on the card and lose the
    CUDA context, so here the logical page is clamped into the table for
    the gather and every out-of-range or invalid position is routed to the
    trash page 0. Only page 0 differs from the reference's writes, and
    nothing reads it unmasked."""
    n_log = page_table.shape[1]
    logical = torch.div(pos, page_size, rounding_mode="floor")
    inside = logical < n_log
    if valid is not None:
        inside = inside & valid
    pid = torch.gather(page_table.long(), 1,
                       torch.clamp(logical, max=n_log - 1))
    return torch.where(inside, pid, 0)


def paged_update_decode(cache: PagedKVCache, k_new, v_new, pos,
                        page_table: torch.Tensor) -> PagedKVCache:
    """Write one token's K/V per row at absolute position ``pos`` (B,)
    through the page table, in place. The engine guarantees the page under
    any LIVE row's write position is exclusively owned (shared prefix
    pages are read-only by construction); dead rows carry an all-trash
    table. Several dead rows can write page 0 at one offset: which write
    wins is undefined, in torch as in JAX, and harmless, because nothing
    reads the trash page unmasked."""
    pg = cache.page_size
    pos = pos.to(cache.k.device).long()[:, None]
    pid = _page_ids(page_table.to(cache.k.device), pos, pg)[:, 0]
    off = torch.remainder(pos[:, 0], pg)
    cache.k[pid, off] = k_new[:, 0]
    cache.v[pid, off] = v_new[:, 0]
    return cache


def paged_update_prefill(cache: PagedKVCache, k_new, v_new, offset,
                         page_table: torch.Tensor,
                         valid_len=None) -> PagedKVCache:
    """Write one prefill chunk (B, C) of K/V at absolute positions
    ``offset[b] + i`` through the page table, in place. ``valid_len`` (B,)
    counts the chunk's valid rows; padded positions go to the trash
    page."""
    b, c = k_new.shape[:2]
    dev = cache.k.device
    rel = torch.arange(c, device=dev)[None, :]
    pos = offset.to(dev).long()[:, None] + rel                # (B, C) abs
    valid = None if valid_len is None else rel < valid_len.to(dev)[:, None]
    pid = _page_ids(page_table.to(dev), pos, cache.page_size, valid)
    off = torch.remainder(pos, cache.page_size)
    cache.k[pid, off] = k_new
    cache.v[pid, off] = v_new
    return cache


def paged_prefill_attention(q, cache: PagedKVCache, page_table, qpos):
    """Chunked-prefill attention: q (B, C, H, Dh) at absolute positions
    ``qpos`` (B, C) attends over the slot's ENTIRE logical cache (history
    from earlier chunks and shared prefix pages included), masked causally
    by absolute position. This is what lets a prompt prefill in chunks,
    unlike the dense prefill path, which attends only within the chunk."""
    k = paged_gather(cache.k, page_table)
    v = paged_gather(cache.v, page_table)
    b, c, h, dh = q.shape
    kvh = k.shape[2]
    g = h // kvh
    qg = q.reshape(b, c, kvh, g, dh) * (dh ** -0.5)
    s = _gqa_scores(qg, k).float()                  # (B,KVH,G,C,S_log)
    kpos = torch.arange(k.shape[1], device=q.device)
    ok = kpos[None, None, :] <= qpos[:, :, None]    # (B, C, S_log)
    s = s + torch.where(ok, 0.0, NEG_INF)[:, None, None, :, :]
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return _gqa_combine(p, v).reshape(b, c, h, dh)


# ---------------------------------------------------------------------------
# Full block-level attention apply
# ---------------------------------------------------------------------------

def apply_attention(p, x: torch.Tensor, cfg: ModelConfig, *,
                    causal: bool = True, window: int = 0,
                    cache: KVCache | None = None, pos=None, states=None,
                    kv_memory=None, valid_len=None, page_table=None,
                    chunked_threshold: int = 2048):
    """Attention sublayer (projections + core + output projection).

    Modes:
      - train:   cache None            -> full attention over x (the flash
                 kernel)
      - prefill: cache given, S > 1    -> token-parallel forward over the
                 prompt from offset ``pos`` (an int, normally 0); K/V of all
                 positions written in one pass, ``valid_len`` (B,) masking
                 the right-padding of bucketed prompts
      - decode:  cache given, S == 1   -> one-token step at ``pos`` (int, or
                 (B,) per-slot tensor), cache updated in place

    A :class:`PagedKVCache` (``page_table`` required, (B, pages_per_slot))
    switches prefill and decode to the paged pool: reads gather the
    slot's logical view through the table, writes scatter through it, and
    prefill becomes CHUNKED: ``pos`` is a (B,) tensor of absolute chunk
    offsets and q attends over the whole logical cache (earlier chunks and
    shared prefix pages), not just the chunk. Paged mode is causal full
    attention only (no sliding window, no cross-attention).

    Returns (out, new_cache, new_states)."""
    paged = isinstance(cache, PagedKVCache)
    if paged:
        if page_table is None:
            raise ValueError("PagedKVCache needs a page_table")
        if window > 0 or kv_memory is not None or not causal:
            raise ValueError("paged KV supports causal full attention only")
    if kv_memory is not None:
        raise NotImplementedError("cross-attention is not ported yet")
    h, kvh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    b, sq, _ = x.shape
    plan = plan_of(cfg)
    st = states or {}
    new_st = dict(st)

    def proj(name, inp):
        spec = plan.linear(f"attn/{name}", inp.shape[-1],
                           bind.linear_out_dim(p[name]))
        y, ns = bind.apply(spec, p[name], inp, cfg.wasi, st.get(name))
        if ns is not None:
            new_st[name] = ns
        return y

    def maybe_rope(t, positions):
        if cfg.rope_theta <= 0:
            return t
        return apply_rope(t, positions, cfg.rope_theta)

    q = proj("wq", x).reshape(b, sq, h, dh)
    k = proj("wk", x).reshape(b, sq, kvh, dh)
    v = proj("wv", x).reshape(b, sq, kvh, dh)
    if cache is None:  # train / full-sequence forward
        positions = torch.arange(sq, device=x.device)
        q, k = maybe_rope(q, positions), maybe_rope(k, positions)
        o = ops.flash_attention(q, k, v, causal=causal, window=window)
        new_cache = None
    elif sq > 1 and paged:  # chunked prefill through the page table
        if pos is None:
            offset = torch.zeros(b, dtype=torch.long, device=x.device)
        else:
            offset = pos.to(x.device).long()
        qpos = offset[:, None] + torch.arange(sq, device=x.device)[None, :]
        q, k = maybe_rope(q, qpos), maybe_rope(k, qpos)
        new_cache = paged_update_prefill(cache, k, v, offset, page_table,
                                         valid_len=valid_len)
        o = paged_prefill_attention(q, new_cache, page_table.to(x.device),
                                    qpos)
    elif sq > 1:  # token-parallel prefill
        if is_vector_pos(pos):
            raise NotImplementedError(
                "per-row prefill offsets (speculative verify) are not "
                "ported yet")
        offset = 0 if pos is None else int(pos)
        positions = offset + torch.arange(sq, device=x.device)
        q, k = maybe_rope(q, positions), maybe_rope(k, positions)
        new_cache = cache_update_prefill(cache, k, v, offset, window=window,
                                         valid_len=valid_len)
        if offset == 0:
            o = ops.flash_attention(q, k, v, causal=causal, window=window)
        else:
            attn = (chunked_attention if sq > chunked_threshold
                    else dense_attention)
            o = attn(q, k, v, causal=causal, window=window, q_offset=offset)
    elif paged:  # decode one token per row through the page table
        if not is_vector_pos(pos):
            raise ValueError("paged decode needs per-row (B,) positions")
        rope_pos = pos.to(x.device)[:, None]
        q, k = maybe_rope(q, rope_pos), maybe_rope(k, rope_pos)
        new_cache = paged_update_decode(cache, k, v, pos, page_table)
        # the per-slot logical view through the SAME masked decode
        # attention the dense path runs: with pages_per_slot x page_size
        # equal to the dense cache's length the shapes are the dense ones
        table = page_table.to(x.device)
        gathered = KVCache(k=paged_gather(new_cache.k, table),
                           v=paged_gather(new_cache.v, table))
        o = decode_attention(q, gathered, pos, window=0)
    else:  # decode one token at ``pos`` (int, or (B,) per row)
        if is_vector_pos(pos):
            rope_pos = pos.to(x.device)[:, None]
        else:
            rope_pos = torch.full((sq,), int(pos), device=x.device)
        q, k = maybe_rope(q, rope_pos), maybe_rope(k, rope_pos)
        new_cache = cache_update(cache, k, v, pos, window=window)
        o = decode_attention(q, new_cache, pos, window=window)
    out = proj("wo", o.reshape(b, sq, h * dh))
    return out, new_cache, new_st
