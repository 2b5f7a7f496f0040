"""Paper-faithful "project" update mode (Eq. 9-11 + Alg. 1). Port of
``repro.core.project``.

Parameters stay DENSE (full W, like the paper's own implementation); a
parallel dict of ``WSIState``s carries each wasi-scoped layer's (L, R).
Per step:

  forward:   y = x R^T L^T    (factors from the PREVIOUS iteration)
  backward:  dW~ = f_LR(x~, dy) lands on W        (wasi_matmul_project)
  update:    W <- W - lr dW~                      (optimizer)
  WSI:       (L, R) <- subspace_iteration(W_new)  (Alg. 1 lines 6-7)

The states are keyed by the weight's path in the param tree, "/"-joined
keys and list indices ending in "/w": ``blocks/mlp/up/w`` of a ViT,
``groups/0/0/mlp/up/w`` of a decoder LM, the same strings the reference's
pytree paths give the same trees. Role scoping is path-based. Stacked
layers (a leading ``repeat`` dim) share one rank, the max over the stack,
and are factored and stepped as one batch.
"""
from __future__ import annotations

import re
from typing import Mapping

import torch
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.core.rank_policy import static_rank
from repro_torch.core.svd import pick_rank
from repro_torch.core.wsi import WSIState, wsi_init, wsi_step

_ROLE_PATTERNS = (
    (r".*(embed|lm_head|head|router|patch|pos|cls)(/|$)", "head"),
    (r".*(experts|shared)/", "moe"),
    (r".*(wq|wk|wv|wo|q_proj|k_proj|v_proj|o_proj)(/|$)", "attn"),
    (r".*(in_proj|x_proj|dt_proj|out_proj)(/|$)", "ssm"),
    (r".*(up|gate|down)(/|$)", "mlp"),
)


def role_of_path(path: str) -> str:
    for pat, role in _ROLE_PATTERNS:
        if re.match(pat, path):
            return role
    return "other"


def _tree(params):
    """The param tree of a model (anything with ``.tree()``), else
    ``params`` itself."""
    return params.tree() if hasattr(params, "tree") else params


def flat_paths(params) -> dict[str, torch.Tensor]:
    """{path: leaf} of a param tree of dicts/lists or nn containers, in
    the reference's path strings."""
    out: dict[str, torch.Tensor] = {}

    def walk(node, prefix):
        if isinstance(node, (Mapping, nn.ModuleDict, nn.ParameterDict)):
            for k, v in node.items():
                walk(v, f"{prefix}/{k}" if prefix else str(k))
        elif isinstance(node, (list, tuple, nn.ModuleList)):
            for i, v in enumerate(node):
                walk(v, f"{prefix}/{i}" if prefix else str(i))
        else:
            out[prefix] = node

    walk(_tree(params), "")
    return out


def _wasi_weight_paths(flat: dict, cfg: ModelConfig) -> list[str]:
    from repro_torch.api.plan import role_treated

    out = []
    for ps, leaf in flat.items():
        role = role_of_path(ps)
        if ps.endswith("/w") and role not in ("head", "other") \
                and leaf.dim() >= 2 and role_treated(cfg.wasi, role):
            out.append(ps)
    return out


def init_project_states(params, cfg: ModelConfig, use_epsilon: bool = False,
                        warm: dict[str, WSIState] | None = None
                        ) -> dict[str, WSIState]:
    """A ``WSIState`` per wasi-scoped dense weight, keyed by path. The rank
    comes from ``rank_frac`` (static) or, with ``use_epsilon``, from the
    explained variance of the actual weights (paper Alg. 1 t = 0; the max
    over stacked layers). ``warm`` carries factors extracted from a
    converted checkpoint (``api.bind.extract_project_factors``): those
    paths skip the SVD and resume the stored subspace."""
    flat = flat_paths(params)
    states: dict[str, WSIState] = {}
    with torch.no_grad():
        for ps in _wasi_weight_paths(flat, cfg):
            if warm and ps in warm:
                states[ps] = warm[ps]
                continue
            w = flat[ps].detach()
            o, i = w.shape[-2:]
            if use_epsilon:
                k = max(pick_rank(m, cfg.wasi.epsilon,
                                  align=cfg.wasi.rank_align)
                        for m in w.reshape(-1, o, i))
            else:
                k = static_rank(i, o, cfg.wasi.rank_frac,
                                align=cfg.wasi.rank_align,
                                min_rank=cfg.wasi.min_rank)
            states[ps] = wsi_init(w, k)
    return states


def project_forward_params(params, states: dict[str, WSIState]):
    """The param tree with (L, R) beside each dense W of ``states``, so
    the bound apply takes the factored-forward, dense-gradient path
    (``wasi_matmul_project``). The structure walk lives in ``api.bind``."""
    from repro_torch.api.bind import inject_factors

    return inject_factors(_tree(params), states)


def update_project_states(params, states: dict[str, WSIState]) -> dict:
    """One WSI step against the freshly updated dense weights (Alg. 1),
    every stacked layer at once; new tensors, no gradient."""
    flat = flat_paths(params)
    with torch.no_grad():
        return {ps: wsi_step(flat[ps].detach(), st)
                for ps, st in states.items()}
