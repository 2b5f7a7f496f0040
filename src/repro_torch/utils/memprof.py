"""Memory accounting the serve engine reports (port of the two helpers of
``repro.utils.memprof`` that ``ServeEngine.summary()`` uses). The measured
telemetry of the reference (residual probes, live watermarks) arrives
with the training slice."""
from __future__ import annotations

import torch


def array_bytes(x: torch.Tensor) -> int:
    """Bytes of one tensor."""
    return x.numel() * x.element_size()


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
