"""Per-request sampling on the device. Port of ``repro.serve.sampling``
(``SamplingParams`` and ``sample_tokens``; the speculative-decoding helpers
arrive with the spec engine).

``sample_tokens`` takes the (B, V) logits where they are (the card) and the
per-slot parameters as host arrays, and returns one token per row, so only
the (B,) token vector crosses to the host each engine tick.

* ``temperature <= 0`` rows are ``argmax`` over the raw logits (first index
  on ties, as ``jnp.argmax``), token for token the lockstep greedy path.
* ``top_k = 0`` / ``top_p = 1.0`` disable those filters.
* A sampled row draws from a ``torch.Generator`` on the logits' device,
  seeded from (request seed, token index) alone. The draw therefore
  depends only on the request's seed and on which of its tokens is being
  drawn, never on the slot, the engine tick or the batch mates. Torch's
  generator is not JAX's: the same seed gives other draws than the
  reference, from the same distribution.
* An all-greedy batch never pays for the sort: the decision is made on
  the host arrays, with no device sync.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

GREEDY_TEMPERATURE = 0.0


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Everything the engine needs to know about one request.

    temperature: 0 => greedy argmax (the default); > 0 scales logits.
    top_k: keep only the k highest logits (0 = off).
    top_p: nucleus sampling mass over the top-k-renormalized distribution
        (1.0 = off).
    seed: per-request RNG seed; None derives a stable one from the rid.
    max_new: generation budget (prefill always emits the first token).
    eos_id: stop token (None = run to max_new).
    deadline_s: wall-clock budget from submit() (priority scheduler).
    priority: higher admits first under the priority scheduler.
    """

    temperature: float = GREEDY_TEMPERATURE
    top_k: int = 0
    top_p: float = 1.0
    seed: int | None = None
    max_new: int = 16
    eos_id: int | None = None
    deadline_s: float | None = None
    priority: int = 0

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError(f"temperature must be >= 0, got {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0 (0 = off), got {self.top_k}")
        if not 0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        if self.max_new < 1:
            raise ValueError("max_new must be >= 1 (prefill always emits "
                             "the first token)")
        if self.deadline_s is not None and self.deadline_s <= 0:
            raise ValueError(f"deadline_s must be > 0, got {self.deadline_s}")

    def resolved(self, rid: int, max_new: int | None = None,
                 eos_id: int | None = None) -> "SamplingParams":
        """Fill per-request defaults: explicit submit() overrides win, and
        a missing seed becomes the rid."""
        return dataclasses.replace(
            self,
            max_new=self.max_new if max_new is None else max_new,
            eos_id=self.eos_id if eos_id is None else eos_id,
            seed=self.seed if self.seed is not None else rid)

    @property
    def is_greedy(self) -> bool:
        return self.temperature <= GREEDY_TEMPERATURE


def draw_seed(seed: int, count: int) -> int:
    """The generator seed of token ``count`` of a request seeded ``seed``:
    a pure function of the two, distinct for distinct pairs."""
    return ((int(seed) & 0xFFFFFFFF) << 32) | (int(count) & 0xFFFFFFFF)


def _filtered_sorted(lg: torch.Tensor, temperature: float, top_k: int,
                     top_p: float):
    """One row: (descending order, temperature-scaled sorted logits with
    the top-k then top-p filters applied as -inf)."""
    v = lg.shape[-1]
    lg = lg.float()
    sorted_lg, order = torch.sort(lg, descending=True, stable=True)
    scaled = sorted_lg / (temperature if temperature > 0 else 1.0)
    ranks = torch.arange(v, device=lg.device)
    keep = ranks < (v if top_k <= 0 else top_k)
    probs = torch.softmax(torch.where(keep, scaled, -torch.inf), dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep &= (cum - probs) < top_p
    keep[0] = True
    return order, torch.where(keep, scaled, -torch.inf)


def sample_tokens(logits: torch.Tensor, temperature, top_k, top_p, seeds,
                  counts) -> torch.Tensor:
    """(B, V) logits -> (B,) int64 tokens on the logits' device.

    temperature/top_p (B,) float, top_k/counts (B,) int, seeds (B,) int,
    all host arrays (numpy or CPU tensors). Rows with temperature <= 0 get
    ``argmax``; a sampled row warps (temperature, then top-k, then top-p
    over the renormalized top-k distribution) and draws by the Gumbel-max
    rule with noise from its own (seed, count) generator."""
    temperature = np.asarray(temperature, np.float64)
    out = torch.argmax(logits, dim=-1)
    sampled = np.nonzero(temperature > 0)[0]
    if len(sampled) == 0:
        return out
    top_k = np.asarray(top_k)
    top_p = np.asarray(top_p, np.float64)
    seeds, counts = np.asarray(seeds), np.asarray(counts)
    for b in sampled.tolist():
        order, masked = _filtered_sorted(logits[b], float(temperature[b]),
                                         int(top_k[b]), float(top_p[b]))
        gen = torch.Generator(device=logits.device)
        gen.manual_seed(draw_seed(seeds[b], counts[b]))
        u = torch.rand(masked.shape, generator=gen, device=logits.device)
        gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
        out[b] = order[torch.argmax(masked + gumbel)]
    return out
