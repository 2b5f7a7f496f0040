"""Decoder language model over layer groups. Port of ``repro.models.lm``
for dense decoder LMs, Mamba-1 (falcon-mamba) and the Mamba-2 hybrid
(zamba2: ``shared_attn``, one attention + MLP block whose weights every
``mamba2_attn`` layer shares).

The parameter tree is the reference's, as modules: ``embed`` and
``final_norm`` are ``ParameterDict``s, ``groups`` is a ``ModuleList`` (one
per layer group) of ``ModuleList``s (one per pattern position) of block
``ModuleDict``s whose leaves carry the group's stacked leading ``repeat``
dim. ``api.bridge`` maps it one-to-one onto the reference's pytree.

The reference's ``lax.scan`` over a group becomes a Python loop over the
stacked dim; ``jax.jit`` becomes eager PyTorch. Decode caches mirror the
groups (leaves (repeat, B, S, KVH, Dh)) and are updated IN PLACE: the
returned caches are the ones passed in. ASI warm-start states (the
``wasi``/``asi`` methods) mirror the groups too, as the reference's
``init_lm_states`` lays them out: per group a list per pattern position
of block state trees whose factors carry the leading ``repeat`` dim
(identity modes stay None). The loop hands layer ``j`` its slice and
stacks the refreshed states it returns into new tensors, as the scan's
``ys`` do. A Mamba layer's cache is ``{"ssm": MambaState(ssm, conv)}``,
``conv`` one buffer (Mamba-1) or the pair (conv_u, conv_bc) (Mamba-2;
``mamba2_attn`` adds its ``"kv"``); its new state
is copied back into the stacked leaves, so those caches too are updated
in place.

Entry points: init_lm / init_lm_states / init_lm_cache, lm_forward
(logits), lm_loss (training), lm_prefill (token-parallel prompt pass that
fills the caches), lm_decode_step. Each takes the model or a plain tree
of the same structure (nested dicts and lists holding the model's own
leaves): project mode's ``core.project.project_forward_params`` hands
``lm_loss`` the tree with a detached (L, R) beside each treated W, as the
reference's ``lm_loss(params, ...)`` takes its pytree. A tree's per-layer
views (``tree_layer_views``) are built anew on every call; the model's
own path keeps ``LanguageModel.layer_views``.

``remat="block"`` (every full config's setting) is the reference's
``jax.checkpoint`` of its scan body: with grad enabled and no caches, one
repeat of a group's pattern (all its pattern positions at one index ``j``)
runs under a non-reentrant ``torch.utils.checkpoint``. The backward keeps
only each body's inputs, the hidden state, the layer's parameter views,
the ASI state slices and the shared block's leaves, all handed to the
checkpoint as flat tensor arguments (so ``utils.memprof`` sees what it
keeps), and reruns the body's forward from them: every kernel of the
forward launches again, and each ASI step runs again from the same input
states. Nothing in a body writes a state in place. The recompute takes the
same kernel routes as the forward: the routes read shapes, dtypes and
16-byte alignment, and the body's inputs are the same tensors while its
intermediates are new allocations of the same shapes (the allocator
aligns every block to 512 bytes). ``remat="none"`` keeps every layer's
saved tensors. Serving (no grad, or caches) never checkpoints. The
computed values do not depend on the setting.
"""
from __future__ import annotations

from typing import Mapping

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.config import ModelConfig
from repro_torch.models.blocks import (
    apply_block,
    init_block,
    init_block_cache,
    init_block_state,
)
from repro_torch.nn.attention import init_attention
from repro_torch.nn.mlp import init_mlp
from repro_torch.nn.norms import apply_norm, init_norm
from repro_torch.utils.device import resolve_device


def _dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


class LanguageModel(nn.Module):
    """Parameter container with the reference's tree; the math lives in
    the module-level functions, as in the reference."""

    def __init__(self, cfg: ModelConfig, embed: nn.ParameterDict,
                 final_norm: nn.ParameterDict, groups: nn.ModuleList,
                 lm_head: nn.ParameterDict | None = None,
                 shared_attn: nn.ModuleDict | None = None):
        super().__init__()
        self.cfg = cfg
        self.embed = embed
        self.final_norm = final_norm
        self.groups = groups
        if lm_head is not None:
            self.lm_head = lm_head
        if shared_attn is not None:
            self.shared_attn = shared_attn
        self._views = None
        self._views_key = None

    def tree(self) -> dict:
        """The params as the reference's nested dict/list (of modules)."""
        t = {"embed": self.embed, "final_norm": self.final_norm,
             "groups": self.groups}
        if hasattr(self, "lm_head"):
            t["lm_head"] = self.lm_head
        if hasattr(self, "shared_attn"):
            t["shared_attn"] = self.shared_attn
        return t

    def layer_views(self) -> list:
        """Per-layer params: ``views[gi][pi][j]`` is layer ``j`` of group
        ``gi`` at pattern position ``pi``, a nested dict of views into the
        stacked leaves.

        With grad enabled and any leaf trainable, the views are built anew
        for every call, so autograd records each ``leaf[j]`` and the
        gradients reach the stacked leaves. Otherwise (serving) they are
        built once, under ``no_grad`` so that they never carry gradient
        history, and rebuilt only when a leaf's storage moves (``.to()``,
        ``load_state_dict``). Every leaf is sliced alike, the int8 weights
        and f32 scales of an int8 deployment included."""
        leaves = list(self.groups.parameters())
        if torch.is_grad_enabled() and any(p.requires_grad for p in leaves):
            return self._build_views()
        key = tuple(p.data_ptr() for p in leaves)
        if self._views_key != key:
            # plain views even when first built under inference_mode, so
            # autograd code can use the cache later
            with torch.inference_mode(False), torch.no_grad():
                self._views = self._build_views()
            self._views_key = key
        return self._views

    def _build_views(self) -> list:
        return [[[_slice(blk, j) for j in range(self.cfg.groups[gi].repeat)]
                 for blk in grp] for gi, grp in enumerate(self.groups)]


def _slice(node, j: int):
    if isinstance(node, (Mapping, nn.ModuleDict, nn.ParameterDict)):
        return {k: _slice(v, j) for k, v in node.items()}
    return node[j]


def tree_layer_views(tree: Mapping, cfg: ModelConfig) -> list:
    """``LanguageModel.layer_views`` of a plain tree: ``views[gi][pi][j]``
    is layer ``j`` of group ``gi`` at pattern position ``pi``, views into
    the tree's stacked leaves (injected L and R included), built anew on
    every call so autograd records each ``leaf[j]``."""
    return [[[_slice(blk, j) for j in range(cfg.groups[gi].repeat)]
             for blk in grp] for gi, grp in enumerate(tree["groups"])]


def _part(params, key: str):
    """Top-level part ``key`` (``embed``, ``final_norm``, ``lm_head``,
    ``shared_attn``) of a model or a tree; None where it has none."""
    if isinstance(params, Mapping):
        return params.get(key)
    return getattr(params, key, None)


def needs_shared(cfg: ModelConfig) -> bool:
    """Does the config run zamba2's shared attention block?"""
    return any("mamba2_attn" in g.pattern for g in cfg.groups)


def init_lm(cfg: ModelConfig, *, device=None, dtype=None,
            generator: torch.Generator | None = None,
            seed: int = 0) -> LanguageModel:
    """Init params in the layouts the config's SubspacePlan (``plan_of``)
    dictates, drawn from ``generator`` (default: a CPU generator seeded
    with ``seed``) and moved to ``device`` (default CUDA; raises if
    absent). One seed gives the same weights on every device."""
    dev = resolve_device(device)
    dtype = dtype or _dtype(cfg.dtype)
    if generator is None:
        generator = torch.Generator().manual_seed(seed)
    d, v = cfg.d_model, cfg.padded_vocab
    gen_dev = generator.device

    def normal(shape, std):
        t = torch.randn(*shape, generator=generator, device=gen_dev) * std
        return nn.Parameter(t.to(device=dev, dtype=dtype),
                            requires_grad=False)

    embed = nn.ParameterDict({"w": normal((v, d), 0.02)})
    final_norm = init_norm(cfg.norm, d, dtype=dtype, device=dev)
    lm_head = None
    if not cfg.tie_embeddings:
        lm_head = nn.ParameterDict({"w": normal((v, d), d ** -0.5)})
    shared = None
    if needs_shared(cfg):
        kw = dict(dtype=dtype, device=dev)
        shared = nn.ModuleDict({
            "ln": init_norm(cfg.norm, d, **kw),
            "attn": init_attention(cfg, generator=generator, **kw),
            "ln2": init_norm(cfg.norm, d, **kw),
            "mlp": init_mlp(cfg, generator=generator, **kw)})
    groups = nn.ModuleList()
    for g in cfg.groups:
        groups.append(nn.ModuleList(
            init_block(kind, cfg, generator=generator, lead=(g.repeat,),
                       dtype=dtype, device=dev) for kind in g.pattern))
    return LanguageModel(cfg, embed, final_norm, groups, lm_head, shared)


def map_states(fn, *trees):
    """Map ``fn`` over the tensor leaves of state trees with one structure
    (dicts, lists, tuples and NamedTuples, None an empty subtree)."""
    t0 = trees[0]
    if t0 is None:
        return None
    if isinstance(t0, dict):
        return {k: map_states(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, list):
        return [map_states(fn, *(t[i] for t in trees))
                for i in range(len(t0))]
    if isinstance(t0, tuple):
        kids = [map_states(fn, *(t[i] for t in trees))
                for i in range(len(t0))]
        return type(t0)(*kids) if hasattr(t0, "_fields") else tuple(kids)
    return fn(*trees)


def _stack_states(per_layer: list):
    """Per-layer state trees -> one tree with a leading ``repeat`` dim."""
    return map_states(lambda *ts: torch.stack(ts), *per_layer)


def _layer_states(stacked, j: int):
    """Layer ``j``'s slice of a stacked state tree (views)."""
    return map_states(lambda t: t[j], stacked)


def init_lm_states(cfg: ModelConfig, batch: int, seq: int, *,
                   dtype=torch.float32, device=None,
                   generator: torch.Generator | None = None,
                   seed: int = 0) -> list:
    """ASI warm-start states mirroring ``groups``: per group, per pattern
    position, a block state tree stacked on the group's ``repeat`` dim.
    Drawn from ``generator`` (default: a CPU generator seeded with
    ``seed``) and moved to ``device`` (default CUDA; raises if absent)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(seed)
    return [[_stack_states([
        init_block_state(kind, cfg, batch, seq, generator=generator,
                         dtype=dtype, device=dev) for _ in range(g.repeat)])
        for kind in g.pattern] for g in cfg.groups]


def init_lm_cache(cfg: ModelConfig, batch: int, seq: int, *,
                  dtype=torch.bfloat16, device=None) -> list:
    """Decode caches mirroring ``groups`` (leaves stacked on ``repeat``)."""
    dev = resolve_device(device)
    return [[init_block_cache(kind, cfg, batch, seq, lead=(g.repeat,),
                              dtype=dtype, device=dev)
             for kind in g.pattern] for g in cfg.groups]


def _layer_cache(gcache: dict, j: int) -> dict:
    """Layer ``j``'s slice of a stacked cache (views)."""
    return map_states(lambda t: t[j], gcache)


def _write_back(layer_cache: dict, new_cache: dict) -> None:
    """Copy a Mamba layer's new recurrent and conv state into its slice
    of the stacked cache (KV slices are written in place already)."""
    if "ssm" in new_cache:
        map_states(lambda dst, src: dst.copy_(src), layer_cache["ssm"],
                   new_cache["ssm"])


def _flatten(tree) -> tuple[list, object]:
    """(leaves, skeleton) of a tree ``map_states`` walks: the skeleton
    holds each leaf's index in ``leaves``."""
    leaves: list = []

    def take(t):
        leaves.append(t)
        return len(leaves) - 1

    return leaves, map_states(take, tree)


def _unflatten(skeleton, leaves):
    return map_states(lambda i: leaves[i], skeleton)


def _as_tree(node):
    """A module of parameters (or a dict holding modules) as nested dicts
    of its tensors."""
    if isinstance(node, (Mapping, nn.ModuleDict, nn.ParameterDict)):
        return {k: _as_tree(v) for k, v in node.items()}
    return node


def _apply_pattern(pattern, cfg: ModelConfig, x, params: list, states,
                   shared, caches=None, pos=None, valid_len=None):
    """One repeat of a group's pattern, the reference's scan body: each
    pattern position's block in turn on its layer's ``params``, ``states``
    and ``caches`` slices. Returns (x, new states per position)."""
    new = []
    for pi, kind in enumerate(pattern):
        cache = None if caches is None else caches[pi]
        x, nc, ns, _ = apply_block(
            kind, params[pi], x, cfg, shared=shared, cache=cache, pos=pos,
            states=None if states is None else states[pi],
            valid_len=valid_len)
        if cache is not None:
            _write_back(cache, nc)
        new.append(ns)
    return x, new


def _checkpointed_pattern(pattern, cfg: ModelConfig, x, params: list,
                          states, shared, pos=None, valid_len=None):
    """``_apply_pattern`` under a non-reentrant checkpoint, every tensor it
    reads (``pos`` and ``valid_len`` too, as the reference's body reads
    them) passed as a flat argument. The body draws no random numbers, so
    no RNG state is stashed."""
    leaves, skeleton = _flatten((params, states, shared, pos, valid_len))

    def body(h, *flat):
        p, s, sh, ps, vl = _unflatten(skeleton, flat)
        return _apply_pattern(pattern, cfg, h, p, s, sh, pos=ps,
                              valid_len=vl)

    return checkpoint(body, x, *leaves, use_reentrant=False,
                      preserve_rng_state=False)


def lm_backbone(model, x, cfg: ModelConfig, *, states=None, caches=None,
                pos=None, valid_len=None):
    """Run embedded hidden states through all layer groups, a loop over
    each group's repeats, each repeat one pass of the group's pattern
    (checkpointed under ``remat="block"`` with grad enabled and no
    caches). ``model``: a ``LanguageModel`` or its tree (injected L and R
    ride into each checkpoint as flat arguments with the layer's other
    views). Returns (x, new_states, caches, aux); new_states is None
    without ``states``."""
    if isinstance(model, LanguageModel):
        views = model.layer_views()
    else:
        views = tree_layer_views(model, cfg)
    shared = _part(model, "shared_attn")
    remat = (cfg.remat == "block" and caches is None
             and torch.is_grad_enabled())
    if remat and shared is not None:
        shared = _as_tree(shared)
    new_states = []
    for gi, g in enumerate(cfg.groups):
        out = [[] for _ in g.pattern]
        for j in range(g.repeat):
            params = [views[gi][pi][j] for pi in range(len(g.pattern))]
            st = (None if states is None else
                  [_layer_states(s, j) for s in states[gi]])
            if remat:
                x, ns = _checkpointed_pattern(g.pattern, cfg, x, params, st,
                                              shared, pos, valid_len)
            else:
                cache = (None if caches is None else
                         [_layer_cache(c, j) for c in caches[gi]])
                x, ns = _apply_pattern(g.pattern, cfg, x, params, st, shared,
                                       cache, pos, valid_len)
            if states is not None:
                for o, s in zip(out, ns):
                    o.append(s)
        if states is not None:
            new_states.append([_stack_states(o) for o in out])
    x = apply_norm(cfg.norm, _part(model, "final_norm"), x)
    return x, (new_states if states is not None else None), caches, 0.0


def _logits(model, x, cfg: ModelConfig):
    head = _part(model, "embed" if cfg.tie_embeddings else "lm_head")["w"]
    logits = torch.matmul(x, head.T)
    if cfg.logit_softcap > 0:
        c = cfg.logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits


def _embed(model, tokens, cfg: ModelConfig):
    return _part(model, "embed")["w"][tokens].to(_dtype(cfg.dtype))


def lm_forward(model, tokens, cfg: ModelConfig, *, states=None, caches=None,
               pos=None):
    """tokens (B, S) -> logits (B, S, V). Returns (logits, states, caches,
    aux). Float ``tokens`` are taken as precomputed embeddings. ``model``:
    a ``LanguageModel`` or its tree."""
    if tokens.is_floating_point():
        x = tokens.to(_dtype(cfg.dtype))
    else:
        x = _embed(model, tokens, cfg)
    x, ns, nc, aux = lm_backbone(model, x, cfg, states=states,
                                 caches=caches, pos=pos)
    return _logits(model, x, cfg), ns, nc, aux


def lm_loss(model, batch: dict, cfg: ModelConfig, *, states=None,
            policy=None):
    """Cross-entropy (f32 reductions) + 0.01 x MoE aux. batch: {tokens
    (B, S), labels (B, S)}; labels < 0 are masked out. ``model``: a
    ``LanguageModel`` or its tree (project mode's, with the factors
    injected). Returns (loss, (new_states, metrics)) with metrics ``ce``,
    ``aux``, ``ppl_proxy``."""
    if policy is not None:
        raise NotImplementedError("sharding policies arrive with the "
                                  "distributed slice (ROADMAP.md queue 1)")
    from repro_torch.nn.losses import masked_xent

    logits, ns, _, aux = lm_forward(model, batch["tokens"], cfg,
                                    states=states)
    labels = batch["labels"]
    mask = (labels >= 0).float()
    ce = masked_xent(logits, torch.clamp(labels, min=0), mask)
    aux = torch.as_tensor(aux, dtype=torch.float32, device=ce.device)
    loss = ce + 0.01 * aux
    metrics = {"ce": ce, "aux": aux,
               "ppl_proxy": torch.exp(torch.clamp(ce, max=20.0))}
    return loss, (ns, metrics)


def lm_decode_step(model, token, caches, pos, cfg: ModelConfig):
    """One serve step. token (B, 1) int; ``pos`` the absolute position of
    this token: an int (lockstep batch) or a (B,) tensor of per-slot
    positions. Returns (logits (B, V), caches)."""
    x = _embed(model, token, cfg)
    x, _, nc, _ = lm_backbone(model, x, cfg, caches=caches, pos=pos)
    return _logits(model, x, cfg)[:, 0], nc


def lm_prefill(model, tokens, cfg: ModelConfig, *, caches,
               valid_len=None, last_only: bool = False, pos=None):
    """Token-parallel prefill: ONE forward over the whole prompt that also
    writes every layer's KV cache. tokens (B, P) from absolute position 0
    (or the int ``pos``); ``valid_len`` (B,) gives true lengths of rows
    right-padded to a bucket. ``last_only`` gathers each row's last VALID
    hidden state before the output projection and returns (B, 1, V).
    Returns (logits, caches)."""
    x = _embed(model, tokens, cfg)
    x, _, nc, _ = lm_backbone(model, x, cfg, caches=caches,
                              pos=0 if pos is None else pos,
                              valid_len=valid_len)
    if last_only:
        if valid_len is None:
            last = torch.full((x.shape[0],), x.shape[1] - 1,
                              device=x.device)
        else:
            last = valid_len.to(x.device).long() - 1
        x = x[torch.arange(x.shape[0], device=x.device), last][:, None]
    return _logits(model, x, cfg), nc
