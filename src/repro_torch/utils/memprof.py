"""Measured memory telemetry. Port of ``repro.utils.memprof``: weight
accounting, backward-residual probes, live-bytes watermarks and the
device allocator's peak.

1. ``measured_residual_bytes`` runs a function under
   ``torch.autograd.graph.saved_tensors_hooks`` and counts the bytes of
   every tensor autograd saves for the backward, deduplicated by storage
   (a Tucker factor shared by the x~ and h~ residuals counts once; a view
   counts its whole storage, the memory it keeps alive). The reference
   counts the residual arrays of a ``jax.vjp`` closure the same way.
2. ``live_bytes`` / ``LiveWatermark``: the bytes of live tensors at step
   boundaries, on the card ``torch.cuda.memory_allocated`` (every tensor
   of the caching allocator), on the CPU the storages of the tensors the
   garbage collector can reach.
3. ``device_peak_bytes``: the CUDA allocator's intra-step high-water mark
   (``torch.cuda.max_memory_allocated``); None on the CPU, which has no
   such counter: output says "n/a" there, never a made-up number.
"""
from __future__ import annotations

import gc
from typing import Callable, NamedTuple

import torch


def array_bytes(x: torch.Tensor) -> int:
    """Bytes of one tensor."""
    return x.numel() * x.element_size()


def _cuda(device) -> bool:
    return device is not None and torch.device(device).type == "cuda"


def live_bytes(device=None) -> int:
    """Bytes of the live tensors on ``device`` (default the CPU): the
    CUDA allocator's count on the card; on the CPU the storages of the
    tensors reachable by the garbage collector, each storage once."""
    if _cuda(device):
        return torch.cuda.memory_allocated(device)
    seen: set[int] = set()
    total = 0
    for obj in gc.get_objects():
        # type(), not isinstance: isinstance reads ``__class__``, which
        # some module proxies answer with a deprecation warning
        if not issubclass(type(obj), torch.Tensor) \
                or obj.device.type != "cpu":
            continue
        st = obj.untyped_storage()
        if st.data_ptr() in seen:
            continue
        seen.add(st.data_ptr())
        total += st.nbytes()
    return total


def device_peak_bytes(device=None) -> int | None:
    """The CUDA allocator's peak bytes since the last
    ``torch.cuda.reset_peak_memory_stats``, or None off the card."""
    if not _cuda(device):
        return None
    return torch.cuda.max_memory_allocated(device)


class LiveWatermark:
    """Step-boundary live-bytes watermark for host-driven training loops.

    ``sample()`` after each step; ``peak`` is the highest boundary total
    seen, ``baseline`` the first. Pairs with ``device_peak_bytes``, which
    sees intra-step transients on the card."""

    def __init__(self, device=None):
        self.device = device
        self.baseline = live_bytes(device)
        self.peak = self.baseline
        self.last = self.baseline

    def sample(self) -> int:
        if _cuda(self.device):
            torch.cuda.synchronize(self.device)
        self.last = live_bytes(self.device)
        self.peak = max(self.peak, self.last)
        return self.last

    def metrics(self, prefix: str = "mem_") -> dict:
        """Metrics merged into the train loop's logging."""
        out = {f"{prefix}live_mib": self.last / 2**20,
               f"{prefix}live_peak_mib": self.peak / 2**20}
        dev = device_peak_bytes(self.device)
        if dev is not None:
            out[f"{prefix}dev_peak_mib"] = dev / 2**20
        return out


class ResidualReport(NamedTuple):
    total_bytes: int
    n_arrays: int
    storages: frozenset   # data pointers of the saved storages


def measured_residual_bytes(fn: Callable, *args, **kwargs) -> ResidualReport:
    """Measure the saved-for-backward bytes of ``fn(*args, **kwargs)``.

    Floating-point tensor arguments are differentiated (a detached alias
    that requires grad, same storage); anything else that requires grad
    (a model's trainable parameters) is differentiated as it is. Every
    tensor autograd saves, including those a ``torch.autograd.Function``
    saves, is counted once per storage. An argument kept alive as a
    residual counts too: if the dense activation is saved, this reports
    it. The output is not used.

    The probe graph has no backward: the hook keeps each saved storage
    alive in a list of its own (so no two saved tensors share an address
    by reuse) and hands autograd a placeholder, never the tensor. A hook
    that returned the tensor would tie each saved output to its own
    ``grad_fn`` in a cycle that Python's collector cannot see, and the
    whole graph would outlive the call."""
    seen: dict[int, int] = {}
    keep: list = []

    def pack(t: torch.Tensor):
        st = t.untyped_storage()
        if st.data_ptr() not in seen:
            seen[st.data_ptr()] = st.nbytes()
            keep.append(st)
        return None

    def unpack(_):
        raise RuntimeError("measured_residual_bytes: the probe graph has "
                           "no backward")

    def prep(a):
        if isinstance(a, torch.Tensor) and a.is_floating_point() \
                and not a.requires_grad:
            return a.detach().requires_grad_(True)
        return a

    args = tuple(prep(a) for a in args)
    with torch.enable_grad(), torch.autograd.graph.saved_tensors_hooks(
            pack, unpack):
        out = fn(*args, **kwargs)
    del out, keep
    return ResidualReport(total_bytes=sum(seen.values()), n_arrays=len(seen),
                          storages=frozenset(seen))


def model_weight_bytes(params) -> dict:
    """Linear-site weight storage of a param tree: {"weights_bytes",
    "scales_bytes", "bias_bytes", "total_bytes", "n_linears"}. Like the
    reference it counts every linear-layout dict, tied embedding included;
    norms are excluded."""
    from repro_torch.api.bind import iter_linear_dicts, linear_param_bytes

    out = {"weights_bytes": 0, "scales_bytes": 0, "bias_bytes": 0,
           "n_linears": 0}
    for _, p in iter_linear_dicts(params):
        b = linear_param_bytes(p)
        out["weights_bytes"] += b["weights"]
        out["scales_bytes"] += b["scales"]
        out["bias_bytes"] += b["bias"]
        out["n_linears"] += 1
    out["total_bytes"] = (out["weights_bytes"] + out["scales_bytes"]
                          + out["bias_bytes"])
    return out


# ---------------------------------------------------------------------------
# Per-linear residual accounting (analytic)
# ---------------------------------------------------------------------------

def tucker_residual_bytes(act_shape, ranks, itemsize: int = 4) -> int:
    """Bytes of one linear's Tucker residual (paper Eq. 31/44); the
    sketch's extra last-mode factor is charged by the caller."""
    from repro_torch.core.asi import tucker_storage

    return tucker_storage(act_shape, ranks) * itemsize


def dense_residual_bytes(act_shape, itemsize: int = 4) -> int:
    n = 1
    for d in act_shape:
        n *= d
    return n * itemsize
