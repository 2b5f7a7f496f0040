"""Declarative subspace plan: which subspace each linear lives in, decided
ONCE per model. The port of ``repro.api.plan``.

    plan = resolve(cfg)                       # static rank policy
    plan = resolve(cfg, calibration=params)   # per-site eps-ranks (Alg. 1 t=0)
    install(plan)                # model internals read it via plan_of(cfg)

A :class:`LinearSpec` names one linear *site* (e.g. ``mlp/up``), shared by
every stacked layer, so a calibrated rank is the max over the site's
stack (and over every stack that holds the site). The fields match the
reference's one for one, so a plan's JSON written by either package reads
in the other.

Differences from the reference, all deliberate:

* ``bwd_fits_vmem`` is the TPU VMEM gate of the fused backward: the
  reference takes its one-launch backward only where all of dL (O, K) and
  dR (K, I) fit in VMEM beside the operand tiles, which admits the
  attention sites and rejects the MLP sites at qwen2 widths. The port's
  backward (``kernels/csrc/lowrank_bwd.cu``) keeps no whole accumulator in
  one block: each output tile is owned by one block and the row reduction
  runs inside it, so it serves every site and needs no fit rule. The field
  stays ``None``.
* Calibration reads tensors on any device (or numpy arrays): each
  slice's singular values come from its own device
  (``core.svd.pick_rank``), the card's for a model on the card.
* Of the deployment stamps, ``quantized`` is ported; ``with_draft``,
  ``with_adapter`` and ``with_sharding`` are not yet. Their fields still
  load from JSON.
"""
from __future__ import annotations

import dataclasses
import functools
import json
from dataclasses import dataclass
from typing import Any, Literal, Mapping, Sequence

import numpy as np
import torch
from torch import nn

from repro_torch.config import (
    AsiConfig,
    LayerGroup,
    ModelConfig,
    MoeConfig,
    SsmConfig,
    WasiConfig,
)
from repro_torch.core.rank_policy import (
    asi_mode_ranks,
    epsilon_ranks,
    static_rank,
)

Mode = Literal["dense", "factored", "project"]
Kernel = Literal["einsum", "fused_lowrank"]

#: linear-dict key in a param tree -> (spec name, role).
LEAF_TO_SPEC: dict[str, tuple[str, str]] = {
    "gate": ("mlp/gate", "mlp"),
    "up": ("mlp/up", "mlp"),
    "down": ("mlp/down", "mlp"),
    "wq": ("attn/wq", "attn"),
    "wk": ("attn/wk", "attn"),
    "wv": ("attn/wv", "attn"),
    "wo": ("attn/wo", "attn"),
    "in_proj": ("ssm/in_proj", "ssm"),
    "x_proj": ("ssm/x_proj", "ssm"),
    "dt_proj": ("ssm/dt_proj", "ssm"),
    "out_proj": ("ssm/out_proj", "ssm"),
    "bcdt_proj": ("ssm/bcdt_proj", "ssm_small"),
    "w_gate": ("moe/w_gate", "moe"),
    "w_up": ("moe/w_up", "moe"),
    "w_down": ("moe/w_down", "moe"),
}


def role_treated(wasi: WasiConfig, role: str) -> bool:
    """Does WASI treat this linear? role in {mlp, attn, ssm, ssm_small,
    moe, head}."""
    if wasi.method == "none" or wasi.scope == "none":
        return False
    if role == "head":
        return False  # embeddings / lm_head stay dense
    if wasi.scope == "mlp":
        return role in ("mlp", "moe")
    return True  # scope == "all"


@dataclass(frozen=True)
class LinearSpec:
    """One linear site, fully resolved: where its weights live (mode/rank),
    how its saved activations are compressed (ASI mode-ranks), and which
    kernel route applies it."""

    name: str                 # site id, e.g. "mlp/up"
    role: str                 # mlp | attn | ssm | ssm_small | moe | head
    in_dim: int
    out_dim: int
    mode: Mode = "dense"
    rank: int = 0             # 0 <=> dense
    bias: bool = False
    asi_ranks: tuple[int, ...] | None = None
    kernel: Kernel = "einsum"
    # fit rule of the fused backward; None until the training slice
    bwd_fits_vmem: bool | None = None
    # deployment stamps: ``quant`` is set by SubspacePlan.quantized; the
    # others are not ported yet and are carried through JSON only
    quant: str | None = None
    draft: str | None = None
    adapter: int | None = None
    sharding: tuple[tuple[str, tuple], ...] | None = None

    @property
    def factored_params(self) -> bool:
        """Do this site's PARAMS carry (L, R) factors?"""
        return self.mode == "factored"

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        if self.asi_ranks is not None:
            d["asi_ranks"] = list(self.asi_ranks)
        if self.sharding is not None:
            d["sharding"] = [[leaf, [list(e) if isinstance(e, tuple) else e
                                     for e in entries]]
                             for leaf, entries in self.sharding]
        return d

    @staticmethod
    def from_json(d: Mapping[str, Any]) -> "LinearSpec":
        d = dict(d)
        if d.get("asi_ranks") is not None:
            d["asi_ranks"] = tuple(d["asi_ranks"])
        if d.get("sharding") is not None:
            d["sharding"] = tuple(
                (leaf, tuple(tuple(e) if isinstance(e, list) else e
                             for e in entries))
                for leaf, entries in d["sharding"])
        return LinearSpec(**d)


def resolve_linear_spec(wasi: WasiConfig, name: str, role: str,
                        in_dim: int, out_dim: int, *, bias: bool = False,
                        act_shape: Sequence[int] | None = None,
                        weight=None) -> LinearSpec:
    """Resolve ONE site under ``wasi``. ``weight`` (a dense (..., O, I)
    tensor or array) switches the rank policy from the static
    ``rank_frac`` to the paper's explained-variance ``epsilon`` (Alg. 1
    t = 0 truncated-SVD rank; the max over any leading stack dims)."""
    treated = role_treated(wasi, role)
    if treated and wasi.factored:
        mode: Mode = "factored"
    elif treated and wasi.project:
        mode = "project"
    else:
        mode = "dense"
    rank = 0
    if mode != "dense":
        if weight is not None:
            rank = _epsilon_rank(weight, wasi)
        else:
            rank = static_rank(in_dim, out_dim, wasi.rank_frac,
                               align=wasi.rank_align,
                               min_rank=wasi.min_rank)
    asi_ranks = None
    if treated and wasi.compress_acts and act_shape is not None:
        asi_ranks = _act_mode_ranks(tuple(act_shape), wasi)
    kernel: Kernel = "fused_lowrank" if mode == "factored" else "einsum"
    return LinearSpec(name=name, role=role, in_dim=in_dim, out_dim=out_dim,
                      mode=mode, rank=rank, bias=bias, asi_ranks=asi_ranks,
                      kernel=kernel)


def _act_mode_ranks(act_shape: tuple[int, ...],
                    wasi: WasiConfig) -> tuple[int, ...]:
    """ASI Tucker mode-ranks for an input activation of ``act_shape``
    ((B, N, I) or (B, H, W, I))."""
    a = wasi.asi
    if len(act_shape) == 3:
        fracs = (a.batch_frac, a.token_frac, a.feature_frac)
    else:
        fracs = (a.batch_frac,) + (a.token_frac,) * (len(act_shape) - 2) \
            + (a.feature_frac,)
    return asi_mode_ranks(act_shape, fracs, skip_batch=a.skip_batch,
                          align=a.align)


def _as_weight(x) -> torch.Tensor:
    """A weight as a tensor on its own device, without grad history;
    numpy bfloat16 (the reference's) read as float32, which holds every
    bfloat16 value exactly."""
    if isinstance(x, torch.Tensor):
        return x.detach()
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        a = a.astype(np.float32)
    return torch.tensor(a)


def _epsilon_rank(weight, wasi: WasiConfig) -> int:
    """pick_rank at wasi.epsilon; the max over leading stack dims (stacked
    layers share one rank)."""
    w = _as_weight(weight)
    return max(epsilon_ranks(w.reshape(-1, *w.shape[-2:]), wasi.epsilon,
                             align=wasi.rank_align))


@dataclass(frozen=True)
class SubspacePlan:
    """The resolved-once subspace decision for a whole model: one
    :class:`LinearSpec` per linear site, plus the config they were
    resolved from. Hashable and JSON-serializable."""

    model: ModelConfig
    specs: tuple[LinearSpec, ...] = ()
    batch: int | None = None   # activation-shape hint used for asi_ranks
    seq: int | None = None
    calibrated: bool = False

    @property
    def wasi(self) -> WasiConfig:
        return self.model.wasi

    @functools.cached_property
    def _by_name(self) -> dict[str, LinearSpec]:
        return {s.name: s for s in self.specs}

    def spec(self, name: str) -> LinearSpec:
        return self._by_name[name]

    def linear(self, name: str, in_dim: int | None = None,
               out_dim: int | None = None, *, role: str | None = None,
               bias: bool = False) -> LinearSpec:
        """Spec lookup for a call site. Unknown names or dim overrides fall
        back to resolving a fresh site under the SAME policy."""
        s = self._by_name.get(name)
        if s is not None and (in_dim is None or s.in_dim == in_dim) \
                and (out_dim is None or s.out_dim == out_dim):
            return s
        if in_dim is None or out_dim is None:
            raise KeyError(f"unknown linear site {name!r} and no dims given")
        r = role or (s.role if s is not None
                     else LEAF_TO_SPEC.get(name.split("/")[-1],
                                           (name, name.split("/")[0]))[1])
        return resolve_linear_spec(
            self.wasi, name, r, in_dim, out_dim, bias=bias,
            act_shape=(self.batch, self.seq, in_dim)
            if self.batch and self.seq else None)

    def quantized(self, fmt: str = "int8") -> "SubspacePlan":
        """The deployment view of this plan: every packable site (factored
        {L, R} pairs and dense 2-D weights) stamped ``quant=fmt``; project
        sites keep their training layout. Pair with
        ``convert.quantize(params, plan)``; the stamped plan rides in
        checkpoint manifests, so ``ServeEngine.from_checkpoint`` serves
        int8 with no config in hand."""
        specs = tuple(dataclasses.replace(s, quant=fmt)
                      if s.mode in ("factored", "dense") else s
                      for s in self.specs)
        return dataclasses.replace(self, specs=specs)

    @property
    def is_quantized(self) -> bool:
        return any(s.quant is not None for s in self.specs)

    def summary(self) -> str:
        """Human-readable one-line-per-site table (the reference's, less
        its TPU ``bwd=`` column)."""
        lines = [f"SubspacePlan[{self.model.name}] method={self.wasi.method} "
                 f"update={self.wasi.update_mode} scope={self.wasi.scope}"
                 + (" (eps-calibrated)" if self.calibrated else "")]
        for s in self.specs:
            extra = f" rank={s.rank}" if s.mode != "dense" else ""
            if s.asi_ranks is not None:
                extra += f" asi={list(s.asi_ranks)}"
            for key in ("quant", "draft", "adapter"):
                if getattr(s, key) is not None:
                    extra += f" {key}={getattr(s, key)}"
            lines.append(f"  {s.name:16s} {s.role:9s} "
                         f"({s.in_dim}->{s.out_dim}) {s.mode:8s}"
                         f" {s.kernel}{extra}")
        return "\n".join(lines)

    # -- serialization ------------------------------------------------------

    def to_json(self) -> dict:
        return {"version": 1,
                "model": model_config_to_json(self.model),
                "specs": [s.to_json() for s in self.specs],
                "batch": self.batch, "seq": self.seq,
                "calibrated": self.calibrated}

    @staticmethod
    def from_json(d: Mapping[str, Any]) -> "SubspacePlan":
        return SubspacePlan(
            model=model_config_from_json(d["model"]),
            specs=tuple(LinearSpec.from_json(s) for s in d["specs"]),
            batch=d.get("batch"), seq=d.get("seq"),
            calibrated=bool(d.get("calibrated", False)))

    def dumps(self) -> str:
        return json.dumps(self.to_json(), sort_keys=True)

    @staticmethod
    def loads(s: str) -> "SubspacePlan":
        return SubspacePlan.from_json(json.loads(s))


def model_config_to_json(cfg: ModelConfig) -> dict:
    return dataclasses.asdict(cfg)


def model_config_from_json(d: Mapping[str, Any]) -> ModelConfig:
    d = dict(d)
    d["groups"] = tuple(LayerGroup(pattern=tuple(g["pattern"]),
                                   repeat=int(g["repeat"]))
                        for g in d.get("groups", ()))
    d["moe"] = MoeConfig(**d.get("moe", {}))
    d["ssm"] = SsmConfig(**d.get("ssm", {}))
    w = dict(d.get("wasi", {}))
    w["asi"] = AsiConfig(**w.get("asi", {}))
    d["wasi"] = WasiConfig(**w)
    return ModelConfig(**d)


def _site_dims(cfg: ModelConfig) -> list[tuple[str, str, int, int, bool, int]]:
    """Enumerate (name, role, in_dim, out_dim, bias, act_in_dim) linear
    sites for a config, by family + block kinds, as the reference does:
    attention and the MLP (gated only under SwiGLU) where a block kind
    has them, the Mamba sites, deduplicated by name. Families and kinds
    the port cannot run yet raise."""
    kinds = {k for g in cfg.groups for k in g.pattern}
    unported = kinds - {"dense", "local", "mamba1", "mamba2", "mamba2_attn"}
    if cfg.family not in ("lm", "vit") or unported:
        raise NotImplementedError(
            f"config {cfg.name!r} ({cfg.family}, blocks {sorted(kinds)}) "
            "is not ported yet; only dense (with local), Mamba-1 and "
            "Mamba-2 decoder LMs and ViTs are (ROADMAP.md)")
    d, f = cfg.d_model, cfg.d_ff
    h, kvh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    sites: list[tuple[str, str, int, int, bool, int]] = []
    has_attn = cfg.family == "vit" or bool(
        kinds & {"dense", "local", "mamba2_attn"})
    has_mlp = has_attn
    if has_attn:
        sites += [("attn/wq", "attn", d, h * dh, cfg.qkv_bias, d),
                  ("attn/wk", "attn", d, kvh * dh, cfg.qkv_bias, d),
                  ("attn/wv", "attn", d, kvh * dh, cfg.qkv_bias, d),
                  ("attn/wo", "attn", h * dh, d, False, h * dh)]
    if has_mlp:
        if cfg.mlp_act == "swiglu":
            sites.append(("mlp/gate", "mlp", d, f, False, d))
        sites += [("mlp/up", "mlp", d, f, False, d),
                  ("mlp/down", "mlp", f, d, False, f)]
    ssm = cfg.ssm
    di = ssm.expand * d
    n = ssm.d_state
    if "mamba1" in kinds:
        dtr = ssm.dt_rank or max(d // 16, 1)
        sites += [("ssm/in_proj", "ssm", d, 2 * di, False, d),
                  ("ssm/x_proj", "ssm", di, dtr + 2 * n, False, di),
                  ("ssm/dt_proj", "ssm", dtr, di, True, dtr),
                  ("ssm/out_proj", "ssm", di, d, False, di)]
    if kinds & {"mamba2", "mamba2_attn"}:
        nh = di // ssm.head_dim
        sites += [("ssm/in_proj", "ssm", d, 2 * di, False, d),
                  ("ssm/bcdt_proj", "ssm_small", d, 2 * n + nh, False, d),
                  ("ssm/out_proj", "ssm", di, d, False, di)]
    seen, out = set(), []
    for s in sites:
        if s[0] not in seen:
            seen.add(s[0])
            out.append(s)
    return out


def collect_linear_weights(tree) -> dict[str, list]:
    """Walk a (possibly stacked) DENSE param tree (nested dicts and lists,
    nn containers, or a model with ``.tree()``) collecting each site's
    weight leaves, keyed by spec name. Used for eps-rank calibration."""
    from repro_torch.api.bind import dense_weight  # bind imports plan

    found: dict[str, list] = {}

    def walk(node):
        if isinstance(node, (Mapping, nn.ModuleDict, nn.ParameterDict)):
            for k, v in node.items():
                w = dense_weight(v) if k in LEAF_TO_SPEC else None
                if w is not None:
                    found.setdefault(LEAF_TO_SPEC[k][0], []).append(w)
                else:
                    walk(v)
        elif isinstance(node, (list, tuple, nn.ModuleList)):
            for v in node:
                walk(v)

    walk(tree.tree() if hasattr(tree, "tree") else tree)
    return found


def resolve(cfg: ModelConfig, *, batch: int | None = None,
            seq: int | None = None, calibration=None) -> SubspacePlan:
    """Resolve the plan for ``cfg`` ONCE.

    ``batch``/``seq`` give the activation-shape hint for ASI mode-ranks.
    ``calibration`` is a dense param tree (or a model, or a {site-name:
    weight} mapping): when given, factored/project ranks come from the
    paper's explained-variance threshold on the actual weights instead of
    the static ``rank_frac`` policy, one rank per site, the max over
    every layer that holds it (the stacks concatenated, as the reference
    does)."""
    weights: Mapping[str, Any] = {}
    if calibration is not None:
        if isinstance(calibration, Mapping) and calibration and all(
                hasattr(v, "shape") for v in calibration.values()):
            weights = {k: [v] for k, v in calibration.items()}
        else:
            weights = collect_linear_weights(calibration)
    specs = []
    for name, role, i_dim, o_dim, bias, act_in in _site_dims(cfg):
        w = None
        flat = [t.reshape(-1, o_dim, i_dim)
                for t in map(_as_weight, weights.get(name, ()))
                if tuple(t.shape[-2:]) == (o_dim, i_dim)]
        if flat:
            w = flat[0] if len(flat) == 1 else torch.cat(flat)
        act = (batch, seq, act_in) if batch and seq else None
        specs.append(resolve_linear_spec(cfg.wasi, name, role, i_dim, o_dim,
                                         bias=bias, act_shape=act, weight=w))
    return SubspacePlan(model=cfg, specs=tuple(specs), batch=batch, seq=seq,
                        calibrated=calibration is not None)


# ---------------------------------------------------------------------------
# Per-config memoized lookup + explicit install
# ---------------------------------------------------------------------------

_INSTALLED: dict[ModelConfig, SubspacePlan] = {}


@functools.lru_cache(maxsize=64)
def _resolve_static(cfg: ModelConfig) -> SubspacePlan:
    return resolve(cfg)


def plan_of(cfg: ModelConfig) -> SubspacePlan:
    """The installed plan for this config, else the memoized static
    resolution."""
    p = _INSTALLED.get(cfg)
    return p if p is not None else _resolve_static(cfg)


def install(plan: SubspacePlan) -> SubspacePlan:
    """Make ``plan`` the one ``plan_of(plan.model)`` returns."""
    _INSTALLED[plan.model] = plan
    return plan


def installed(cfg: ModelConfig) -> SubspacePlan | None:
    """The explicitly-installed plan for ``cfg``, if any (no fallback)."""
    return _INSTALLED.get(cfg)


def uninstall(cfg: ModelConfig) -> None:
    _INSTALLED.pop(cfg, None)
