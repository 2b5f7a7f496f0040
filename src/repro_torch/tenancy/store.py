"""Content-addressed on-disk registry of plan-stamped tenant adapters.
Port of ``repro.tenancy.store``; both packages read each other's stores.

Layout (the reference's):

    <root>/objects/<sha256>.npz      leaf payload (leaf_0 .. leaf_N)
    <root>/tenants/<tenant>.json     pointer + metadata

The object name is a sha256 over the tree spec (the reference's
``_tree_spec`` format, ``checkpoint.ckpt._flatten``) and every leaf's
numpy dtype, shape and bytes, not over the npz file (zip timestamps would
make that differ run to run), so identical adapter trees dedupe to one
object however many tenants point at it. Leaves are hashed as numpy
arrays: ``f"{dtype}{shape}"`` of a torch tensor prints otherwise and would
change every sha.

Formats: ``"f32"`` stores the training dtype as it is; ``"int8"`` packs
each (La, Ra) per channel (``quant.quantize.quantize_tensor``), the scales
beside the payload as sLa/sRa. ``load`` always hands back f32: the store
format is a disk format, not a serve layout.

The metadata pins the adapter-stamped plan (its JSON and sha) and the
per-site ranks, so a serving process refuses an adapter trained under
another plan before any shape error. Bytes are exact nbytes of the
stored leaves.
"""
from __future__ import annotations

import hashlib
import json
import os
import re

import numpy as np
import torch

from repro_torch.checkpoint.ckpt import _build_from_spec
from repro_torch.checkpoint.ckpt import _flatten as _flatten_spec
from repro_torch.quant.quantize import dequantize_tensor, quantize_tensor
from repro_torch.tenancy.adapter import adapter_site_ranks, tree_map

#: adapter weight key -> its scale key (int8 storage only; disjoint from
#: the base weights' sL/sR, so ``bind`` never reads them)
ADAPTER_SCALE_KEY = {"La": "sLa", "Ra": "sRa"}

_TENANT_RE = re.compile(r"^[A-Za-z0-9._-]{1,64}$")

FORMATS = ("f32", "int8")


def _check_tenant(tenant: str) -> str:
    if not _TENANT_RE.match(tenant or ""):
        raise ValueError(f"bad tenant id {tenant!r} (want [A-Za-z0-9._-], "
                         "1-64 chars: it names a file)")
    return tenant


def _walk_pairs(tree, fn, key: str):
    """``fn`` at every dict holding ``key``; the rest rebuilt as is."""
    if isinstance(tree, dict):
        if key in tree:
            return fn(tree)
        return {k: _walk_pairs(v, fn, key) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        t = [_walk_pairs(v, fn, key) for v in tree]
        return t if isinstance(tree, list) else tuple(t)
    return tree


def pack_int8(adapters):
    """Adapter tree -> int8 storage tree: every {"La", "Ra"} site becomes
    {"La" int8, "sLa" f32, "Ra" int8, "sRa" f32} (per-channel absmax over
    the contraction axis, the base weights' scheme)."""
    def pack(node):
        out = {}
        for k, v in node.items():
            if k in ADAPTER_SCALE_KEY:
                out[k], out[ADAPTER_SCALE_KEY[k]] = quantize_tensor(v)
            else:
                out[k] = v
        return out

    return _walk_pairs(tree_map(lambda t: t, adapters), pack, "La")


def unpack_int8(stored):
    """Inverse of :func:`pack_int8`: the f32 adapter layout."""
    def unpack(node):
        return {k: dequantize_tensor(v, node[ADAPTER_SCALE_KEY[k]])
                for k, v in node.items() if k in ADAPTER_SCALE_KEY}

    return _walk_pairs(stored, unpack, "sLa")


def _numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten(tree):
    leaves: list = []
    spec = _flatten_spec(tree_map(lambda t: t, tree), leaves)
    return [_numpy(x) for x in leaves], spec


def _content_sha(leaves, spec) -> str:
    h = hashlib.sha256()
    h.update(json.dumps(spec, sort_keys=True).encode())
    for leaf in leaves:
        h.update(f"{leaf.dtype}{leaf.shape}".encode())
        h.update(np.ascontiguousarray(leaf).tobytes())
    return h.hexdigest()


def plan_sha(plan) -> str:
    """sha256 of the plan's JSON (``sort_keys``), the reference's."""
    return hashlib.sha256(
        json.dumps(plan.to_json(), sort_keys=True).encode()).hexdigest()


class AdapterStore:
    """save/load/list plan-stamped adapter trees, content-addressed."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(os.path.join(root, "objects"), exist_ok=True)
        os.makedirs(os.path.join(root, "tenants"), exist_ok=True)

    def _meta_path(self, tenant: str) -> str:
        return os.path.join(self.root, "tenants",
                            f"{_check_tenant(tenant)}.json")

    def _obj_path(self, sha: str) -> str:
        return os.path.join(self.root, "objects", f"{sha}.npz")

    def save(self, tenant: str, adapters, plan, *, fmt: str = "f32",
             extra: dict | None = None) -> dict:
        """Persist one tenant's adapter tree; returns the meta record
        (also written to ``tenants/<tenant>.json``)."""
        if fmt not in FORMATS:
            raise ValueError(f"unknown adapter format {fmt!r}; "
                             f"want one of {FORMATS}")
        if not getattr(plan, "has_adapters", False):
            raise ValueError("plan carries no adapter stamps; refusing to "
                             "store an unstamped tree")
        stored = pack_int8(adapters) if fmt == "int8" else adapters
        leaves, spec = _flatten(stored)
        sha = _content_sha(leaves, spec)
        obj = self._obj_path(sha)
        if not os.path.exists(obj):                      # dedupe
            tmp = obj + f".tmp{os.getpid()}"             # savez adds .npz
            np.savez(tmp, **{f"leaf_{i}": leaf
                             for i, leaf in enumerate(leaves)})
            os.replace(tmp + ".npz", obj)
        meta = {
            "tenant": tenant,
            "object": sha,
            "format": fmt,
            "bytes": int(sum(leaf.nbytes for leaf in leaves)),
            "n_leaves": len(leaves),
            "tree": spec,
            "ranks": adapter_site_ranks(plan),
            "plan_sha": plan_sha(plan),
            "plan": plan.to_json(),
        }
        if extra:
            meta["extra"] = dict(extra)
        mp = self._meta_path(tenant)
        tmp = mp + f".tmp{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(meta, f, indent=1, sort_keys=True)
        os.replace(tmp, mp)
        return meta

    def meta(self, tenant: str) -> dict:
        with open(self._meta_path(tenant)) as f:
            return json.load(f)

    def has(self, tenant: str) -> bool:
        try:
            return os.path.exists(self._meta_path(tenant))
        except ValueError:
            return False

    def load(self, tenant: str, *, expect_plan_sha: str | None = None,
             device=None):
        """-> (f32 adapter tree of tensors on ``device``, default the CPU,
        meta). int8 objects are dequantized here."""
        meta = self.meta(tenant)
        if expect_plan_sha is not None and meta["plan_sha"] != expect_plan_sha:
            raise ValueError(
                f"adapter for tenant {tenant!r} was trained under plan "
                f"{meta['plan_sha'][:12]} but the engine runs "
                f"{expect_plan_sha[:12]}; refusing it")
        with np.load(self._obj_path(meta["object"])) as z:
            leaves = [torch.from_numpy(z[f"leaf_{i}"]).to(
                "cpu" if device is None else device)
                for i in range(meta["n_leaves"])]
        tree = _build_from_spec(meta["tree"], leaves)
        if meta["format"] == "int8":
            tree = unpack_int8(tree)
        return tree, meta

    def tenants(self) -> list[str]:
        d = os.path.join(self.root, "tenants")
        return sorted(n[:-5] for n in os.listdir(d) if n.endswith(".json"))

    def list(self) -> list[dict]:
        return [self.meta(t) for t in self.tenants()]

    def bytes_by_tenant(self) -> dict[str, int]:
        """Per-tenant stored payload bytes (a deduplicated object counts
        once per tenant pointing at it)."""
        return {m["tenant"]: m["bytes"] for m in self.list()}

    def total_object_bytes(self) -> int:
        """The object pool's bytes on disk, after dedupe."""
        d = os.path.join(self.root, "objects")
        return sum(os.path.getsize(os.path.join(d, n))
                   for n in os.listdir(d) if n.endswith(".npz"))
