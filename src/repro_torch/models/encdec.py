"""Encoder-decoder transformer (the Whisper-tiny backbone). Port of
``repro.models.encdec``.

The audio conv frontend is a stub, as in the reference: the encoder takes
precomputed frame embeddings (B, S_enc, d). Positions come from the fixed
sinusoidal table (``nn.rotary.sinusoidal_embedding``; ``rope_theta`` 0
turns RoPE off). Encoder blocks: bidirectional self-attention then a GELU
MLP. Decoder blocks: causal self-attention, cross-attention over the
encoder's memory, then the MLP. The head is tied: logits are ``x @
embed.wᵀ``.

The parameter tree is the reference's, as modules: ``embed``,
``enc_norm`` and ``final_norm`` are ``ParameterDict``s, ``enc`` and
``dec`` ``ModuleDict``s whose leaves carry the stacked leading
``n_enc_layers`` or ``n_layers`` dim, as the reference's ``vmap`` lays
them out. The reference's ``lax.scan`` over a stack is a Python loop over
that dim. ASI states mirror the stacks: ``{"enc": {"attn", "mlp"},
"dec": {"self_attn", "cross_attn", "mlp"}}`` with every factor stacked on
the same dim; ``cross_attn`` is always ``{}`` (its K/V come from the
fixed memory), so under ``wasi`` the cross-attention sites take the
fused factored route (kernels #2 and #3 under grad, #1 without) while
every other site takes the Tucker path.

Every attention of ``encode`` and ``decode_train`` (the encoder's
bidirectional, the decoder's causal, the cross-attention over the 1,500
frames) goes through the flash kernel; so does a decode step's
cross-attention (one query row). A decode step's causal self-attention
over the KV cache stays plain, as the decoder LMs' does.

``remat="block"`` is the reference's ``jax.checkpoint`` of each scan
body: with grad enabled, each encoder and each decoder block runs under a
non-reentrant ``torch.utils.checkpoint``, every tensor it reads (the
hidden state, the memory, the layer's parameter views, its ASI state
slices) handed over as a flat argument, as ``models/lm.py`` does.

Like the reference, a decode step recomputes the cross-attention K/V from
the memory at every layer (its docstring's "precomputed" K/V are not);
caching them is later work (ROADMAP.md). The step computes only row
``pos`` of the sinusoidal table, where the reference builds the whole
``max_seq`` table and slices it: the same arithmetic, the same values.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.config import ModelConfig
from repro_torch.models.lm import (
    _dtype,
    _flatten,
    _layer_states,
    _slice,
    _stack_states,
    _unflatten,
)
from repro_torch.nn.attention import (
    KVCache,
    apply_attention,
    init_attention,
    init_attention_state,
    init_cache,
)
from repro_torch.nn.mlp import apply_mlp, init_mlp, init_mlp_state
from repro_torch.nn.norms import apply_norm, init_norm
from repro_torch.nn.rotary import sinusoidal_angles, sinusoidal_embedding
from repro_torch.utils.device import resolve_device


class EncoderDecoder(nn.Module):
    """Parameter container with the reference's tree; the math lives in
    the module-level functions, as in the reference."""

    def __init__(self, cfg: ModelConfig, embed: nn.ParameterDict,
                 enc: nn.ModuleDict, enc_norm: nn.ParameterDict,
                 dec: nn.ModuleDict, final_norm: nn.ParameterDict):
        super().__init__()
        self.cfg = cfg
        self.embed = embed
        self.enc = enc
        self.enc_norm = enc_norm
        self.dec = dec
        self.final_norm = final_norm

    def tree(self) -> dict:
        """The params as the reference's nested dict (of modules)."""
        return {"embed": self.embed, "enc": self.enc,
                "enc_norm": self.enc_norm, "dec": self.dec,
                "final_norm": self.final_norm}


def init_encdec(cfg: ModelConfig, *, device=None, dtype=None,
                generator: torch.Generator | None = None, seed: int = 0,
                plan=None) -> EncoderDecoder:
    """Init params in the layouts the config's SubspacePlan dictates, drawn
    from ``generator`` (default: a CPU generator seeded with ``seed``) and
    moved to ``device`` (default CUDA; raises if absent). ``plan``: an
    explicitly resolved SubspacePlan, installed first so every linear init
    reads it. Same distributions as the reference; other numbers, since
    torch and JAX draw different streams."""
    if plan is not None:
        from repro_torch.api import install
        install(plan)
    dev = resolve_device(device)
    dtype = dtype or _dtype(cfg.dtype)
    if generator is None:
        generator = torch.Generator().manual_seed(seed)
    d, v = cfg.d_model, cfg.padded_vocab
    t = torch.randn(v, d, generator=generator, device=generator.device)
    embed = nn.ParameterDict({"w": nn.Parameter(
        (t * 0.02).to(device=dev, dtype=dtype), requires_grad=False)})

    def norm(lead=()):
        return init_norm(cfg.norm, d, lead=lead, dtype=dtype, device=dev)

    def attn(n):
        return init_attention(cfg, generator=generator, lead=(n,),
                              dtype=dtype, device=dev)

    def mlp(n):
        return init_mlp(cfg, generator=generator, lead=(n,), dtype=dtype,
                        device=dev)

    ne, nd = cfg.n_enc_layers, cfg.n_layers
    enc = nn.ModuleDict({"ln1": norm((ne,)), "attn": attn(ne),
                         "ln2": norm((ne,)), "mlp": mlp(ne)})
    dec = nn.ModuleDict({"ln1": norm((nd,)), "self_attn": attn(nd),
                         "ln_x": norm((nd,)), "cross_attn": attn(nd),
                         "ln2": norm((nd,)), "mlp": mlp(nd)})
    return EncoderDecoder(cfg, embed, enc, norm(), dec, norm())


def init_encdec_states(cfg: ModelConfig, batch: int, seq: int, *,
                       dtype=torch.float32, device=None,
                       generator: torch.Generator | None = None,
                       seed: int = 0) -> dict:
    """ASI warm-start states (the train path of ``wasi``/``asi``): the
    encoder's at ``cfg.enc_seq`` tokens, the decoder's at ``seq``; every
    factor stacked on its stack's layer dim; {} where the plan leaves a
    sublayer's activations dense, and always at ``cross_attn``."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(seed)
    kw = dict(generator=generator, dtype=dtype, device=dev)
    se = cfg.enc_seq
    enc = [{"attn": init_attention_state(cfg, batch, se, **kw),
            "mlp": init_mlp_state(cfg, batch, se, **kw)}
           for _ in range(cfg.n_enc_layers)]
    dec = [{"self_attn": init_attention_state(cfg, batch, seq, **kw),
            "cross_attn": {},
            "mlp": init_mlp_state(cfg, batch, seq, **kw)}
           for _ in range(cfg.n_layers)]
    return {"enc": _stack_states(enc), "dec": _stack_states(dec)}


def _tree(params):
    return params.tree() if isinstance(params, EncoderDecoder) else params


def _refuse_policy(policy) -> None:
    if policy is not None:
        raise NotImplementedError("sharding policies arrive with the "
                                  "distributed slice (ROADMAP.md queue 1)")


def _enc_block(cfg: ModelConfig, h, p, st):
    """One encoder block: (h, its new states, or None without states)."""
    a, _, ns_a = apply_attention(
        p["attn"], apply_norm(cfg.norm, p["ln1"], h), cfg, causal=False,
        states=None if st is None else st["attn"])
    h = h + a
    f, ns_m = apply_mlp(p["mlp"], apply_norm(cfg.norm, p["ln2"], h), cfg,
                        None if st is None else st["mlp"])
    return h + f, (None if st is None else {"attn": ns_a, "mlp": ns_m})


def _dec_block(cfg: ModelConfig, h, mem, p, st, cache=None, pos=None):
    """One decoder block: (h, its new states or None, the new KV cache)."""
    a, nkv, ns_s = apply_attention(
        p["self_attn"], apply_norm(cfg.norm, p["ln1"], h), cfg, causal=True,
        cache=cache, pos=pos,
        states=None if st is None else st["self_attn"])
    h = h + a
    c, _, _ = apply_attention(
        p["cross_attn"], apply_norm(cfg.norm, p["ln_x"], h), cfg,
        causal=False, kv_memory=mem)
    h = h + c
    f, ns_m = apply_mlp(p["mlp"], apply_norm(cfg.norm, p["ln2"], h), cfg,
                        None if st is None else st["mlp"])
    ns = (None if st is None else
          {"self_attn": ns_s, "cross_attn": {}, "mlp": ns_m})
    return h + f, ns, nkv


def _remat(cfg: ModelConfig) -> bool:
    return cfg.remat == "block" and torch.is_grad_enabled()


def _checkpointed(fn, *args):
    """``fn(*args)`` under a non-reentrant checkpoint, every tensor of
    ``args`` (nested dicts of parameter views and states) passed as a flat
    argument. The blocks draw no random numbers, so no RNG state is
    stashed."""
    leaves, skeleton = _flatten(args)

    def body(*flat):
        return fn(*_unflatten(skeleton, flat))

    return checkpoint(body, *leaves, use_reentrant=False,
                      preserve_rng_state=False)


def _stack_or_none(per_layer: list, states):
    return None if states is None else _stack_states(per_layer)


def encode(params, frames: torch.Tensor, cfg: ModelConfig, *, states=None,
           policy=None):
    """frames (B, S_enc, d) from the frontend stub -> (memory (B, S_enc,
    d) in the config's dtype, the encoder's new ASI states or None).
    ``params``: the model or its tree."""
    _refuse_policy(policy)
    p = _tree(params)
    x = frames.to(_dtype(cfg.dtype))
    x = x + sinusoidal_embedding(x.shape[1], cfg.d_model, x.dtype,
                                 x.device)[None]
    remat = _remat(cfg)
    new = []
    for j in range(cfg.n_enc_layers):
        lp = _slice(p["enc"], j)
        st = None if states is None else _layer_states(states["enc"], j)
        if remat:
            x, ns = _checkpointed(lambda h, a, b: _enc_block(cfg, h, a, b),
                                  x, lp, st)
        else:
            x, ns = _enc_block(cfg, x, lp, st)
        new.append(ns)
    return (apply_norm(cfg.norm, p["enc_norm"], x),
            _stack_or_none(new, states))


def _embed(p, tokens, cfg: ModelConfig):
    """The reference's gather: the table in f32, then the model's dtype."""
    return p["embed"]["w"].float()[tokens].to(_dtype(cfg.dtype))


def _head(p, x):
    return torch.matmul(x, p["embed"]["w"].T)


def decode_train(params, tokens, memory, cfg: ModelConfig, *, states=None,
                 policy=None):
    """Teacher-forced decoder pass: tokens (B, S) -> (logits (B, S, V),
    the decoder's new ASI states or None). ``states``: the whole
    ``init_encdec_states`` tree (its ``dec`` part is read)."""
    _refuse_policy(policy)
    p = _tree(params)
    x = _embed(p, tokens, cfg)
    x = x + sinusoidal_embedding(x.shape[1], cfg.d_model, x.dtype,
                                 x.device)[None]
    remat = _remat(cfg)
    new = []
    for j in range(cfg.n_layers):
        lp = _slice(p["dec"], j)
        st = None if states is None else _layer_states(states["dec"], j)
        if remat:
            x, ns = _checkpointed(
                lambda h, m, a, b: _dec_block(cfg, h, m, a, b)[:2],
                x, memory, lp, st)
        else:
            x, ns, _ = _dec_block(cfg, x, memory, lp, st)
        new.append(ns)
    x = apply_norm(cfg.norm, p["final_norm"], x)
    return _head(p, x), _stack_or_none(new, states)


def encdec_loss(params, batch: dict, cfg: ModelConfig, *, states=None,
                policy=None):
    """Masked cross-entropy of the decoder's logits. batch: {frames (B,
    S_enc, d), tokens (B, S), labels (B, S)}; labels < 0 are masked out.
    Returns (ce, (new states {"enc", "dec"} or None, {"ce"}))."""
    from repro_torch.nn.losses import masked_xent

    memory, ns_enc = encode(params, batch["frames"], cfg, states=states,
                            policy=policy)
    logits, ns_dec = decode_train(params, batch["tokens"], memory, cfg,
                                  states=states, policy=policy)
    labels = batch["labels"]
    mask = (labels >= 0).float()
    ce = masked_xent(logits, torch.clamp(labels, min=0), mask)
    ns = {"enc": ns_enc, "dec": ns_dec} if states is not None else None
    return ce, (ns, {"ce": ce})


def init_encdec_cache(cfg: ModelConfig, batch: int, seq: int, *,
                      dtype=torch.bfloat16, device=None) -> dict:
    """The decoder's self-attention KV caches, {"kv": KVCache} with leaves
    (n_layers, B, seq, KVH, Dh)."""
    dev = resolve_device(device)
    return {"kv": init_cache(cfg, batch, seq, lead=(cfg.n_layers,),
                             dtype=dtype, device=dev)}


def encdec_decode_step(params, token, memory, caches, pos: int,
                       cfg: ModelConfig, *, policy=None):
    """One greedy-decode step: token (B, 1) at position ``pos`` (an int,
    the same for every row), memory (B, S_enc, d). Each layer's K/V is
    written into its slice of ``caches`` in place. Returns (logits (B,
    V), caches)."""
    _refuse_policy(policy)
    p = _tree(params)
    x = _embed(p, token, cfg)
    row = torch.tensor([int(pos)], device=x.device)
    x = x + sinusoidal_angles(row, cfg.d_model).to(x.dtype)[None]
    kv = caches["kv"]
    for j in range(cfg.n_layers):
        cache = KVCache(k=kv.k[j], v=kv.v[j])
        x, _, _ = _dec_block(cfg, x, memory, _slice(p["dec"], j), None,
                             cache=cache, pos=pos)
    x = apply_norm(cfg.norm, p["final_norm"], x)
    return _head(p, x)[:, 0], caches

