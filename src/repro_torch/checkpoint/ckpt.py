"""Sharded, atomic, async checkpoints with restart. Port of
``repro.checkpoint.ckpt``, writing and reading the reference's on-disk
layout byte for byte:

    <dir>/step_<N>/
        manifest.json        tree spec + leaf metadata (+ plan, label, extras)
        proc<P>_leaf<i>.npy  one file per leaf per process

* Leaf order is JAX's flatten order of the same tree (dicts by sorted key,
  lists and tuples in order, NamedTuples by field, None an empty subtree),
  so a directory written by either package restores in the other.
* The port's trees are ``nn.Module``s. A ``LanguageModel`` or a
  ``VisionTransformer`` is written as its reference param tree
  (``model.tree()``); the port's ``TrainState`` as the reference's
  ``TrainState(params, OptState(step, mu, nu), asi, wsi, psgd, step)``
  with PowerSGD's part None and the steps int32. ``asi`` is the ASI
  states' tree as the reference lays it out (``ASIState(us=...)``,
  identity modes None, so they add no leaf); ``wsi`` project mode's
  ``{path: WSIState(L, R)}`` (None in the other modes).
* bfloat16 leaves are written as the reference writes them, a 2-byte void
  array whose ``.npy`` header says ``'<V2'``, with ``"bfloat16"`` in the
  manifest, and read back through an int16 view; ``ml_dtypes`` is not
  needed on either side. (The reference itself cannot read such a leaf
  back template-free: ``np.load`` gives ``|V2``, which JAX refuses.)
* Atomic publish: files go to ``step_<N>.tmp<P>``, renamed into place; a
  second process publishing the same step merges its files in. A stale
  ``.tmp`` is never counted and is swept at ``CheckpointManager`` start.
* Restores give CPU tensors; restoring into a model or a ``TrainState``
  copies into its parameters in place.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, NamedTuple

import numpy as np
import torch
from torch import nn

_STEP_RE = re.compile(r"^step_(\d+)$")
_TMP_RE = re.compile(r"^step_(\d+)\.tmp\d*$")


class _RefOptState(NamedTuple):
    step: Any
    mu: Any
    nu: Any


class _RefTrainState(NamedTuple):
    params: Any
    opt: Any
    asi: Any
    wsi: Any
    psgd: Any
    step: Any


# the reference's class names, as its tree spec strings print them
_RefOptState.__name__ = "OptState"
_RefTrainState.__name__ = "TrainState"


def _is_leaf(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray, np.generic, int, float,
                          bool))


def _is_train_state(x) -> bool:
    from repro_torch.train.step import TrainState
    return isinstance(x, TrainState)


def _module_tree(node):
    """nn containers, at any depth, -> plain dicts/lists with the same
    leaves; NamedTuples keep their type."""
    if isinstance(node, (dict, nn.ModuleDict, nn.ParameterDict)):
        return {k: _module_tree(v) for k, v in node.items()}
    if isinstance(node, (list, nn.ModuleList)):
        return [_module_tree(v) for v in node]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*(_module_tree(v) for v in node))
    if isinstance(node, tuple):
        return tuple(_module_tree(v) for v in node)
    return node


def _named(tree, prefix: str = ""):
    """(dotted name, leaf) pairs of a plain tree, in the names
    ``named_parameters`` gives the same tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named(v, f"{prefix}.{k}" if prefix else str(k))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _named(v, f"{prefix}.{i}" if prefix else str(i))
    else:
        yield prefix, tree


def _nest(tree, named: dict, prefix: str = ""):
    if isinstance(tree, dict):
        return {k: _nest(v, named, f"{prefix}.{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_nest(v, named, f"{prefix}.{i}" if prefix else str(i))
                for i, v in enumerate(tree)]
    return named[prefix]


def as_tree(obj):
    """The reference-shaped tree the checkpoint stores for ``obj``: a
    ``LanguageModel`` (anything with ``.tree()``) becomes its param tree,
    the port's ``TrainState`` the reference's ``TrainState``; plain
    nested dicts/lists/tuples pass through."""
    if _is_train_state(obj):
        params = _module_tree(obj.params.tree())

        def moments(d):
            return None if d is None else _nest(params, d)

        opt = obj.opt
        return _RefTrainState(
            params=params,
            opt=_RefOptState(step=np.asarray(opt.step, np.int32),
                             mu=moments(opt.mu), nu=moments(opt.nu)),
            asi=_module_tree(obj.asi), wsi=_module_tree(obj.wsi),
            psgd=None,
            step=np.asarray(obj.step, np.int32))
    if isinstance(obj, nn.Module) and hasattr(obj, "tree"):
        return _module_tree(obj.tree())
    return _module_tree(obj)


def _flatten(tree, out: list) -> dict:
    """Append ``tree``'s leaves to ``out`` in JAX's flatten order; return
    its structural spec (the reference's ``_tree_spec`` format)."""
    if tree is None:
        return {"kind": "none"}
    if isinstance(tree, dict):
        keys = sorted(tree)
        return {"kind": "dict", "keys": keys,
                "children": [_flatten(tree[k], out) for k in keys]}
    if isinstance(tree, tuple):
        return {"kind": "tuple",
                "children": [_flatten(v, out) for v in tree]}
    if isinstance(tree, list):
        return {"kind": "list", "children": [_flatten(v, out) for v in tree]}
    if _is_leaf(tree):
        out.append(tree)
        return {"kind": "leaf", "index": len(out) - 1}
    raise TypeError(f"cannot checkpoint a {type(tree).__name__} node")


def treedef_str(tree) -> str:
    """The string ``str(jax.tree_util.tree_structure(tree))`` gives for the
    same tree, as the reference's manifest records it."""
    def walk(t) -> str:
        if t is None:
            return "None"
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {walk(t[k])}"
                                   for k in sorted(t)) + "}"
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return (f"CustomNode(namedtuple[{type(t).__name__}], ["
                    + ", ".join(walk(v) for v in t) + "])")
        if isinstance(t, tuple):
            inner = ", ".join(walk(v) for v in t)
            return f"({inner},)" if len(t) == 1 else f"({inner})"
        if isinstance(t, list):
            return "[" + ", ".join(walk(v) for v in t) + "]"
        return "*"

    return f"PyTreeDef({walk(tree)})"


def _build_from_spec(spec: dict, leaves: list):
    kind = spec["kind"]
    if kind == "none":
        return None
    if kind == "dict":
        return {k: _build_from_spec(c, leaves)
                for k, c in zip(spec["keys"], spec["children"])}
    if kind == "list":
        return [_build_from_spec(c, leaves) for c in spec["children"]]
    if kind == "tuple":
        return tuple(_build_from_spec(c, leaves) for c in spec["children"])
    return leaves[spec["index"]]


# ---------------------------------------------------------------------------
# leaves on disk
# ---------------------------------------------------------------------------

def _numpy(leaf) -> tuple[np.ndarray, str]:
    """(array, the dtype name the manifest records) of one leaf on the
    host; a bf16 leaf as its int16 bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        return t.numpy(), str(t.numpy().dtype)
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":    # an ml_dtypes array from a caller
        return arr.view(np.int16), "bfloat16"
    return arr, str(arr.dtype)


def _write_leaf(path: str, leaf) -> dict:
    """Write one leaf; return its manifest entry's shape and dtype."""
    arr, dtype = _numpy(leaf)
    if dtype != "bfloat16":
        np.save(path, arr)
    else:
        # the header np.save writes for an ml_dtypes bfloat16 array, then
        # the raw little-endian bits
        with open(path, "wb") as f:
            np.lib.format.write_array_header_1_0(
                f, {"descr": "<V2", "fortran_order": False,
                    "shape": arr.shape})
            f.write(np.ascontiguousarray(arr, "<i2").tobytes())
    return {"shape": list(arr.shape), "dtype": dtype}


def _read_leaf(path: str, dtype: str | None = None) -> torch.Tensor:
    """One ``.npy`` leaf as a CPU tensor; a leaf the manifest calls
    ``bfloat16``, or any 2-byte void array, through an int16 view."""
    arr = np.load(path)
    if not arr.flags.c_contiguous:
        arr = arr.copy(order="C")
    if dtype == "bfloat16" or (arr.dtype.kind == "V"
                               and arr.dtype.itemsize == 2):
        bits = arr.view("<i2").astype(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16)
    return torch.from_numpy(arr)


# ---------------------------------------------------------------------------
# save / restore
# ---------------------------------------------------------------------------

def save_checkpoint(ckpt_dir: str, step: int, tree, *,
                    process_index: int = 0, plan=None,
                    label: str | None = None,
                    extra: dict[str, Any] | None = None) -> str:
    """Synchronous save of ``tree`` (a model, the port's ``TrainState`` or
    a nested dict/list/tuple of tensors or arrays). Returns the published
    directory. ``plan`` (a SubspacePlan, or anything with ``to_json()``)
    and ``label`` ride in the manifest; ``extra`` saves named side trees
    beside the main one, restored by :func:`restore_extra`."""
    final = os.path.join(ckpt_dir, f"step_{step}")
    tmp = final + f".tmp{process_index}"
    os.makedirs(tmp, exist_ok=True)
    tree = as_tree(tree)
    leaves: list = []
    spec = _flatten(tree, leaves)
    meta = []
    for i, leaf in enumerate(leaves):
        meta.append({"index": i, **_write_leaf(
            os.path.join(tmp, f"proc{process_index}_leaf{i}.npy"), leaf)})
    manifest: dict[str, Any] = {
        "step": step, "n_leaves": len(leaves), "leaves": meta,
        "treedef": treedef_str(tree), "tree": spec}
    if label is not None:
        manifest["label"] = label
    if plan is not None:
        manifest["plan"] = plan.to_json() if hasattr(plan, "to_json") else plan
    if extra:
        manifest["extras"] = {}
        for name, ext_tree in extra.items():
            if not re.fullmatch(r"[A-Za-z0-9_.-]+", name):
                raise ValueError(f"extra name {name!r} must be a plain "
                                 "filename token")
            ext_leaves: list = []
            try:
                espec = _flatten(as_tree(ext_tree), ext_leaves)
            except TypeError as e:
                raise ValueError(
                    f"extra {name!r} is not a plain dict/list/tuple tree "
                    "of arrays; extras must restore template-free") from e
            for i, leaf in enumerate(ext_leaves):
                _write_leaf(os.path.join(
                    tmp, f"proc{process_index}_{name}_{i}.npy"), leaf)
            manifest["extras"][name] = {"tree": espec,
                                        "n_leaves": len(ext_leaves)}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        # the step is already published (another process's shards, or a
        # re-save after restart): merge our files in, never rmtree theirs
        for name in os.listdir(tmp):
            os.replace(os.path.join(tmp, name), os.path.join(final, name))
        shutil.rmtree(tmp, ignore_errors=True)
    else:
        os.rename(tmp, final)
    return final


def _published_steps(ckpt_dir: str) -> list[int]:
    """Steps with a published (renamed, manifest-bearing) directory."""
    steps = []
    for name in os.listdir(ckpt_dir):
        m = _STEP_RE.match(name)
        if m and os.path.exists(os.path.join(ckpt_dir, name, "manifest.json")):
            steps.append(int(m.group(1)))
    return sorted(steps)


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = _published_steps(ckpt_dir)
    return steps[-1] if steps else None


def sweep_stale_tmp(ckpt_dir: str,
                    process_index: int | None = None) -> list[str]:
    """Remove ``step_<N>.tmp<P>`` dirs left by a crash mid-save; only this
    process's own when ``process_index`` is given (a peer may be mid-save),
    every one when it is None. Returns the removed paths."""
    removed = []
    if not os.path.isdir(ckpt_dir):
        return removed
    suffix = None if process_index is None else f".tmp{process_index}"
    for name in os.listdir(ckpt_dir):
        if _TMP_RE.match(name) and (suffix is None or name.endswith(suffix)):
            path = os.path.join(ckpt_dir, name)
            shutil.rmtree(path, ignore_errors=True)
            removed.append(path)
    return removed


def load_manifest(ckpt_dir: str, step: int) -> dict:
    with open(os.path.join(ckpt_dir, f"step_{step}", "manifest.json")) as f:
        return json.load(f)


def _read_leaves(ckpt_dir: str, step: int, process_index: int) -> list:
    m = load_manifest(ckpt_dir, step)
    d = os.path.join(ckpt_dir, f"step_{step}")
    dtypes = {e["index"]: e.get("dtype") for e in m.get("leaves", [])}
    return [_read_leaf(os.path.join(d, f"proc{process_index}_leaf{i}.npy"),
                       dtypes.get(i)) for i in range(m["n_leaves"])]


def _unflatten_like(template, it):
    """``template``'s structure (container types kept) over leaves from
    the iterator ``it``."""
    if template is None:
        return None
    if isinstance(template, dict):
        return {k: _unflatten_like(template[k], it) for k in sorted(template)}
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(_unflatten_like(v, it) for v in template))
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten_like(v, it) for v in template)
    return next(it)


def _copy_into(dst: dict, src: dict) -> None:
    with torch.no_grad():
        for name, p in dst.items():
            p.copy_(src[name])


def restore_checkpoint(ckpt_dir: str, step: int, template, *,
                       process_index: int = 0):
    """Restore into the structure of ``template`` (shapes validated).

    A model or the port's ``TrainState`` is filled IN PLACE (its
    parameters copied into) and returned; the state's optimizer moments
    come back as new f32 tensors on each parameter's device, its ASI and
    WSI states as new tensors on the devices of the template's. Any other
    tree comes back with its structure and CPU tensors for leaves."""
    tree = as_tree(template)
    want: list = []
    _flatten(tree, want)
    got = _read_leaves(ckpt_dir, step, process_index)
    if len(got) != len(want):
        raise ValueError(f"checkpoint has {len(got)} leaves, template "
                         f"{len(want)}")
    for i, (a, b) in enumerate(zip(got, want)):
        shape = tuple(getattr(b, "shape", np.shape(b)))
        if tuple(a.shape) != shape:
            raise ValueError(f"leaf {i}: checkpoint shape {tuple(a.shape)} "
                             f"!= {shape}")
    back = _unflatten_like(tree, iter(got))
    if _is_train_state(template):
        from repro_torch.optim import OptState

        model = template.params
        params = dict(model.named_parameters())
        _copy_into(params, dict(_named(back.params)))

        def moments(tree_):
            if tree_ is None:
                return None
            return {n: t.to(params[n].device, torch.float32)
                    for n, t in _named(tree_)}

        opt = OptState(step=int(back.opt.step), mu=moments(back.opt.mu),
                       nu=moments(back.opt.nu))
        from repro_torch.models.lm import map_states
        asi, wsi = (map_states(lambda got, want: got.to(want.device), b, t)
                    for b, t in ((back.asi, template.asi),
                                 (back.wsi, template.wsi)))
        return template._replace(opt=opt, step=int(back.step), asi=asi,
                                 wsi=wsi)
    if isinstance(template, nn.Module) and hasattr(template, "tree"):
        _copy_into(dict(template.named_parameters()), dict(_named(back)))
        return template
    return back


def restore_extra(ckpt_dir: str, step: int, name: str, *,
                  process_index: int = 0):
    """A named side tree saved with ``save_checkpoint(extra=...)``,
    template-free; None when the checkpoint has no such extra."""
    m = load_manifest(ckpt_dir, step)
    ext = (m.get("extras") or {}).get(name)
    if ext is None:
        return None
    d = os.path.join(ckpt_dir, f"step_{step}")
    leaves = [_read_leaf(os.path.join(d, f"proc{process_index}_{name}_{i}.npy"))
              for i in range(ext["n_leaves"])]
    return _build_from_spec(ext["tree"], leaves)


def restore_untyped(ckpt_dir: str, step: int, *, process_index: int = 0):
    """Template-free restore from the manifest's tree spec: nested
    dicts/lists/tuples of CPU tensors (NamedTuples come back as tuples).
    Raises if the checkpoint has no tree spec."""
    m = load_manifest(ckpt_dir, step)
    spec = m.get("tree")
    if spec is None:
        raise ValueError(
            f"checkpoint {ckpt_dir}/step_{step} has no structural tree spec; "
            "restore with restore_checkpoint(template) instead")
    return _build_from_spec(spec, _read_leaves(ckpt_dir, step,
                                               process_index))


def _snapshot(tree):
    """The tree with every leaf copied to the host, so later in-place
    updates of the caller's tensors do not reach the checkpoint."""
    tree = as_tree(tree)
    leaves: list = []
    _flatten(tree, leaves)
    return _unflatten_like(tree, iter(
        [x.detach().to("cpu", copy=True) if isinstance(x, torch.Tensor)
         else np.array(x, copy=True) for x in leaves]))


class CheckpointManager:
    """Async save, retention, restart and crash hygiene."""

    def __init__(self, ckpt_dir: str, keep: int = 3, process_index: int = 0,
                 plan=None, label: str | None = None):
        self.dir = ckpt_dir
        self.keep = keep
        self.process_index = process_index
        self.plan = plan
        self.label = label
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None
        os.makedirs(ckpt_dir, exist_ok=True)
        # a previous run died mid-save: this process's tmp dirs were never
        # published; a peer's may be a live save and stay
        sweep_stale_tmp(ckpt_dir, process_index)

    def wait(self):
        """Join the background write; re-raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save_async(self, step: int, tree, extra: dict | None = None):
        """Snapshot to the host on the caller's thread (the state as of
        this call), write on a background thread."""
        self.wait()
        host_tree = _snapshot(tree)
        host_extra = ({k: _snapshot(v) for k, v in extra.items()}
                      if extra else None)

        def _write():
            try:
                save_checkpoint(self.dir, step, host_tree,
                                process_index=self.process_index,
                                plan=self.plan, label=self.label,
                                extra=host_extra)
                self._gc()
            except Exception as e:  # re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()

    def save(self, step: int, tree, extra: dict | None = None):
        self.wait()
        save_checkpoint(self.dir, step, tree,
                        process_index=self.process_index,
                        plan=self.plan, label=self.label, extra=extra)
        self._gc()

    def restore_latest(self, template):
        """(step, restored) of the newest published step, or (None, None)."""
        self.wait()
        step = latest_step(self.dir)
        if step is None:
            return None, None
        return step, restore_checkpoint(self.dir, step, template,
                                        process_index=self.process_index)

    def restore_extra(self, step: int, name: str):
        self.wait()
        return restore_extra(self.dir, step, name,
                             process_index=self.process_index)

    def _gc(self):
        steps = _published_steps(self.dir)
        for s in steps[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)
