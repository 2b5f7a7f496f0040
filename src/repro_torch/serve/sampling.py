"""Per-request sampling on the device. Port of ``repro.serve.sampling``:
``SamplingParams``, ``sample_tokens`` and the speculative-decoding helpers
``warped_probs``, ``sample_draft_tokens`` and ``spec_accept``.

``sample_tokens`` takes the (B, V) logits where they are (the card) and the
per-slot parameters as host arrays, and returns one token per row, so only
the (B,) token vector crosses to the host each engine tick.

* ``temperature <= 0`` rows are ``argmax`` over the raw logits (first index
  on ties, as ``jnp.argmax``), token for token the lockstep greedy path.
* ``top_k = 0`` / ``top_p = 1.0`` disable those filters.
* The sampled rows are warped together, one sort for all of them
  (``_filtered_sorted``), and each draws from a ``torch.Generator`` on the
  logits' device, seeded from (request seed, token index) alone. The draw
  therefore depends only on the request's seed and on which of its tokens
  is being drawn, never on the slot, the engine tick or the batch mates.
  Torch's generator is not JAX's: the same seed gives other draws than the
  reference, from the same distribution.
* An all-greedy batch never pays for the sort: the decision is made on
  the host arrays, with no device sync.

Speculative decoding draws three more streams per token index, each
seeded by ``spec_seed(seed, index, salt)`` (``SALT_DRAFT`` for the draft's
proposal, ``SALT_ACCEPT`` for the accept test's uniform, ``SALT_FIX`` for
the corrected resample and the bonus token), the counterparts of the
reference's ``fold_in(fold_in(key(seed), n), salt)``: pure functions of
(seed, index, salt), distinct from ``draw_seed`` and from each other.
``warped_probs`` is built on the same ``_filtered_sorted`` as
``sample_tokens``, so q is exactly the distribution a proposal was drawn
from and p exactly what ``sample_tokens`` draws from: the rejection rule
is then lossless.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

GREEDY_TEMPERATURE = 0.0

# speculative-decoding streams per token index (``spec_seed``)
SALT_DRAFT, SALT_ACCEPT, SALT_FIX = 1, 2, 3


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



_MASK64 = (1 << 64) - 1
#: token indices a spec seed packs below its salt (``spec_seed``)
_INDEX_BITS = 30


def _mix64(z: int) -> int:
    """splitmix64's finalizer: a bijection of 64-bit integers whose every
    output bit depends on every input bit."""
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def draw_seed(seed: int, count: int) -> int:
    """The generator seed of token ``count`` of a request seeded ``seed``:
    a pure function of the two, distinct for distinct pairs (the packed
    pair through a bijective mix, so the low 32 bits, all that a CPU
    generator keeps of its seed, depend on both)."""
    return _mix64(((int(seed) & 0xFFFFFFFF) << 32)
                  | (int(count) & 0xFFFFFFFF))


def spec_seed(seed: int, index: int, salt: int) -> int:
    """The seed of speculative stream ``salt`` (``SALT_DRAFT``,
    ``SALT_ACCEPT``, ``SALT_FIX``) at token ``index``: ``draw_seed`` of the
    index with the salt packed above its 30 bits, so it is distinct from
    every ``draw_seed(seed, count)`` of a count below 2^30 and from the
    other salts' seeds."""
    if not 0 <= int(index) < 1 << _INDEX_BITS:
        raise ValueError(f"token index {index} outside [0, 2^30)")
    return draw_seed(seed, (int(salt) << _INDEX_BITS) | int(index))


def _uniform(seed: int, index: int, salt: int) -> float:
    """One uniform in [0, 1) of stream ``salt`` at token ``index``, drawn
    on the host from a generator of that seed (an accept test needs one
    number)."""
    return float(np.random.default_rng(spec_seed(seed, index, salt))
                 .random())


def _safe_log(p: torch.Tensor) -> torch.Tensor:
    """log(p) with exact -inf on zero-probability entries."""
    return torch.where(p > 0, torch.log(torch.clamp(p, min=1e-38)),
                       -torch.inf)


def _filtered_sorted(lg: torch.Tensor, temperature, top_k, top_p):
    """Rows (..., V) of logits and per-row parameters (host arrays of the
    leading shape, or broadcastable to it) -> (descending order, the
    temperature-scaled sorted logits with the top-k then top-p filters
    applied as -inf), one sort for every row. A row at temperature <= 0 is
    warped at temperature 1 (greedy rows never read it)."""
    v = lg.shape[-1]
    lg = lg.float()
    t, k, p = (torch.as_tensor(np.asarray(a, dt), device=lg.device).expand(
        lg.shape[:-1]) for a, dt in ((temperature, np.float32),
                                     (top_k, np.int64), (top_p, np.float32)))
    sorted_lg, order = torch.sort(lg, dim=-1, descending=True, stable=True)
    scaled = sorted_lg / torch.where(t > 0, t, 1.0)[..., None]
    ranks = torch.arange(v, device=lg.device)
    keep = ranks < torch.where(k > 0, k, v)[..., None]
    probs = torch.softmax(torch.where(keep, scaled, -torch.inf), dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep &= (cum - probs) < p[..., None]
    keep[..., 0] = True
    return order, torch.where(keep, scaled, -torch.inf)


def sample_tokens(logits: torch.Tensor, temperature, top_k, top_p, seeds,
                  counts) -> torch.Tensor:
    """(B, V) logits -> (B,) int64 tokens on the logits' device.

    temperature/top_p (B,) float, top_k/counts (B,) int, seeds (B,) int,
    all host arrays (numpy or CPU tensors). Rows with temperature <= 0 get
    ``argmax``; the sampled rows are warped together (``_filtered_sorted``:
    temperature, then top-k, then top-p over the renormalized top-k
    distribution) and each draws by the Gumbel-max rule with noise from its
    own (seed, count) generator."""
    temperature = np.asarray(temperature, np.float32)
    out = torch.argmax(logits, dim=-1)
    sampled = np.nonzero(temperature > 0)[0]
    if len(sampled) == 0:
        return out
    seeds, counts = np.asarray(seeds), np.asarray(counts)
    rows = torch.as_tensor(sampled, device=logits.device)
    order, masked = _filtered_sorted(
        logits[rows], temperature[sampled], np.asarray(top_k)[sampled],
        np.asarray(top_p)[sampled])
    picks = _categorical(masked, [draw_seed(seeds[b], counts[b])
                                  for b in sampled.tolist()])
    out[rows] = torch.gather(order, -1, picks[:, None])[:, 0]
    return out


def warped_probs(logits: torch.Tensor, temperature, top_k,
                 top_p) -> torch.Tensor:
    """The post-filter next-token distribution in VOCAB order: (..., V)
    logits -> (..., V) f32 probabilities after the warp ``sample_tokens``
    draws from (``_filtered_sorted``, then a softmax), so it is the q
    (draft) and p (target) of the speculative rejection rule. Parameters
    are host arrays of the logits' leading shape (or broadcastable to
    it); all rows go through one sort. Rows at temperature <= 0 are
    warped at temperature 1 (greedy rows accept by argmax, not by
    ratio)."""
    order, masked = _filtered_sorted(logits, temperature, top_k, top_p)
    probs = torch.softmax(masked, dim=-1)
    return torch.empty_like(probs).scatter_(-1, order, probs)


def _categorical(scores: torch.Tensor, seeds: list) -> torch.Tensor:
    """The one Gumbel-max draw of this module: row r of ``scores`` (N, V)
    f32 log-probabilities (up to a constant per row; -inf excluded) ->
    argmax(scores[r] + g_r), g_r Gumbel noise from a generator seeded
    ``seeds[r]`` on the rows' device. A row whose seed is None gets no
    noise (its argmax; callers overwrite it)."""
    dev = scores.device
    noise = torch.zeros(scores.shape, dtype=torch.float32, device=dev)
    for r, s in enumerate(seeds):
        if s is None:
            continue
        gen = torch.Generator(device=dev)
        gen.manual_seed(s)
        u = torch.rand(scores.shape[-1], generator=gen, device=dev)
        noise[r] = -torch.log(-torch.log(u.clamp_min(1e-20)))
    return torch.argmax(scores + noise, dim=-1)


def sample_draft_tokens(logits: torch.Tensor, temperature, top_k, top_p,
                        seeds, counts):
    """One draft step's proposal: (B, V) draft logits -> ((B,) int64
    tokens, (B, V) f32 q) on the logits' device. ``counts`` (host) is the
    absolute index of the token being proposed. q is the warped draft
    distribution the proposal was drawn from (``spec_accept`` needs its
    ratio); a sampled row draws from it with a ``SALT_DRAFT`` uniform.
    Greedy rows propose argmax; an all-greedy batch skips the warp and
    returns the one-hot of its proposals as q (never read)."""
    temperature = np.asarray(temperature, np.float32)
    greedy = torch.argmax(logits, dim=-1)
    if not (temperature > 0).any():
        q = torch.zeros(logits.shape, dtype=torch.float32,
                        device=logits.device)
        return greedy, q.scatter_(-1, greedy[:, None], 1.0)
    q = warped_probs(logits, temperature, top_k, top_p)
    seeds, counts = np.asarray(seeds), np.asarray(counts)
    drawn = _categorical(_safe_log(q), [
        spec_seed(seeds[b], counts[b], SALT_DRAFT) if temperature[b] > 0
        else None for b in range(len(temperature))])
    hot = torch.as_tensor(temperature > 0, device=logits.device)
    return torch.where(hot, drawn, greedy), q


def spec_accept(target_logits: torch.Tensor, draft_toks: torch.Tensor,
                draft_q: torch.Tensor, draft_len, temperature, top_k, top_p,
                seeds, counts):
    """The standard speculative rejection rule over all k positions at once,
    on the logits' device.

    target_logits (B, k+1, V): the verify logits; position i is the
        target's next-token distribution given the first i draft tokens.
    draft_toks (B, k) int64 and draft_q (B, k, V) f32: the proposals and
        the warped draft distributions they were drawn from.
    draft_len (B,) host ints: live proposals per row (rows near their
        cache capacity draft fewer than k; dead rows draft 0).
    temperature/top_k/top_p/seeds (B,) host arrays: the sampling state;
    counts (B,) host: each request's sampled-token count at spec-step
        start, so position i is token index counts + i.

    Returns (n_acc (B,), out (B, k+1)) int64 tensors: row b emits
    ``out[b, :n_acc[b] + 1]``, the accepted prefix and one more token (the
    corrected resample from normalize(max(p - q, 0)) on a rejection, or
    the bonus draw from p at the draft's end).

    Greedy rows accept while the proposal equals the target's argmax and
    emit the argmaxes: token for token the non-spec greedy generation.
    Sampled rows accept proposal i iff u_i q_i(d_i) < p_i(d_i), u_i a
    ``SALT_ACCEPT`` uniform; the resample and bonus draw with
    ``SALT_FIX`` uniforms. An all-greedy batch skips every sort."""
    bsz, kk = draft_toks.shape
    dev = target_logits.device
    dl = np.asarray(draft_len, np.int64)
    live = torch.as_tensor(np.arange(kk)[None, :] < dl[:, None], device=dev)
    tgt = torch.argmax(target_logits, dim=-1)                   # (B, k+1)
    match = (draft_toks == tgt[:, :kk]) & live
    m_greedy = torch.cumprod(match.long(), dim=1).sum(dim=1)
    temperature = np.asarray(temperature, np.float32)
    hot = temperature > 0
    if not hot.any():
        return m_greedy, tgt

    def rep(a):
        return np.repeat(np.asarray(a)[:, None], kk + 1, axis=1)

    p = warped_probs(target_logits, rep(temperature), rep(top_k),
                     rep(top_p))                                # (B,k+1,V)
    q_d = torch.gather(draft_q, -1, draft_toks[..., None])[..., 0]
    p_d = torch.gather(p[:, :kk], -1, draft_toks[..., None])[..., 0]
    seeds, counts = np.asarray(seeds), np.asarray(counts)
    u = np.zeros((bsz, kk), np.float32)
    fix_seeds: list = [None] * (bsz * (kk + 1))
    for b in np.nonzero(hot)[0].tolist():
        c = int(counts[b])
        u[b] = [_uniform(seeds[b], c + i, SALT_ACCEPT) for i in range(kk)]
        for i in range(kk):
            fix_seeds[b * (kk + 1) + i] = spec_seed(seeds[b], c + i,
                                                    SALT_FIX)
        fix_seeds[b * (kk + 1) + kk] = spec_seed(seeds[b], c + int(dl[b]),
                                                 SALT_FIX)
    u = torch.as_tensor(u, device=dev)
    accept = (u * torch.clamp(q_d, min=1e-38) < p_d) & live
    m = torch.cumprod(accept.long(), dim=1).sum(dim=1)
    # the corrected resample per position: normalize(max(p - q, 0)), p
    # itself where that residual is identically zero
    res = torch.clamp(p[:, :kk] - draft_q, min=0.0)
    res = torch.where(res.sum(dim=-1, keepdim=True) > 0, res, p[:, :kk])
    rows = torch.arange(bsz, device=dev)
    dl_t = torch.as_tensor(dl, device=dev)
    bonus = p[rows, dl_t]                                       # (B, V)
    dists = torch.cat([res, bonus[:, None]], dim=1)             # (B,k+1,V)
    draws = _categorical(_safe_log(dists.reshape(-1, dists.shape[-1])),
                         fix_seeds).reshape(bsz, kk + 1)
    r_at_m = draws[rows, torch.clamp(m, max=kk - 1)]
    fix = torch.where(m < dl_t, r_at_m, draws[:, kk])
    out = torch.cat([draft_toks, torch.zeros_like(draft_toks[:, :1])], dim=1)
    out[rows, m] = fix
    greedy = torch.as_tensor(~hot, device=dev)
    return (torch.where(greedy, m_greedy, m),
            torch.where(greedy[:, None], tgt, out))
