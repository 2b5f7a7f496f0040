"""Continuous-batching serve engine over a fixed slot pool. Port of
``repro.serve.engine`` in DENSE-SLOT mode.

* The engine owns ONE set of batched decode caches (``init_lm_cache`` with
  batch = max_slots: KV caches, and for Mamba-2 layers the SSM state and
  both conv buffers). A slot is a batch row: admitting a request prefills
  its prompt into that row, finishing (or cancelling, or evicting) frees
  the row for the next queued request.
* Prefill is token-parallel (``lm_prefill``): admitted prompts are
  right-padded to bucket lengths and same-bucket admissions prefill
  together as one batch (rows gathered out of the caches, prefilled,
  scattered back).
* Decode runs ALL slots every tick at per-slot positions (``pos`` a (B,)
  vector). Free slots ride along as dead rows that keep writing K/V at
  their stale positions; the causal masks never read those back, and the
  row is re-prefilled before it is read again.
* Sampling runs on the device (``serve/sampling.py``); only the (B,)
  sampled tokens reach the host each tick.

* An int8 deployment (``plan.quantized("int8")`` with
  ``convert.quantize``) serves through the same engine: every factored
  linear then runs the int8 kernel (``kernels/csrc/lowrank_q8.cu``), and
  ``summary()`` reports ``quantized`` and the packed ``weight_bytes``.
  ``ServeEngine.from_checkpoint`` builds the engine from a plan-bearing
  checkpoint with no config in hand.

Where the reference jits and donates the caches, this engine runs eager
PyTorch under ``torch.inference_mode()`` and updates the caches in place.
Not ported yet (they raise ``NotImplementedError``): paged KV pools,
speculative decoding, tenant adapters and mesh serving.
"""
from __future__ import annotations

import collections
import time
from typing import Sequence

import numpy as np
import torch

from repro_torch.api.bind import check_layout
from repro_torch.api.plan import SubspacePlan, install, installed, plan_of
from repro_torch.config import ModelConfig
from repro_torch.models.lm import (
    LanguageModel,
    _dtype,
    init_lm_cache,
    lm_decode_step,
    lm_prefill,
    map_states,
)
from repro_torch.serve.sampling import SamplingParams, sample_tokens
from repro_torch.serve.scheduler import Scheduler, make_scheduler
from repro_torch.serve.session import Event, EventKind, GenerationHandle, Request
from repro_torch.utils.device import resolve_device

DEFAULT_BUCKETS = (8, 16, 32, 64, 128, 256)


def bucket_for(length: int, buckets: Sequence[int],
               max_cache: int | None = None) -> int:
    """Smallest bucket >= length. Prompts beyond the largest bucket round
    UP to the next multiple of it, and every result is capped at
    ``max_cache``."""
    cap = max_cache if max_cache is not None else float("inf")
    for b in buckets:
        if b >= length:
            return int(min(b, cap))
    big = buckets[-1]
    return int(min(-(-length // big) * big, cap))


def _tree_leaves(caches):
    """Every cache tensor (KV, SSM state, both conv buffers), in one
    order."""
    out = []
    map_states(out.append, caches)
    return out


def _install(plan: SubspacePlan) -> SubspacePlan:
    """Install ``plan`` for its config, unless a different plan is
    installed there already (a quantized plan differs from its f32 one)."""
    current = installed(plan.model)
    if current is None:
        return install(plan)
    if current != plan:
        raise ValueError(
            "a different SubspacePlan is already installed for this "
            "ModelConfig; api.uninstall(cfg) it first, or build the engine "
            "with that plan")
    return current


class ServeEngine:
    """Streaming continuous-batching engine over a fixed slot pool."""

    def __init__(self, params: LanguageModel, cfg: ModelConfig | None = None,
                 *, plan: SubspacePlan | None = None, max_slots: int = 4,
                 max_cache: int = 512,
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 scheduler: Scheduler | str = "fcfs",
                 paged: bool | str = False, spec_k: int = 0,
                 adapters=None, mesh=None, device=None):
        for name, val in (("paged", paged), ("spec_k", spec_k),
                          ("adapters", adapters), ("mesh", mesh)):
            if val:
                raise NotImplementedError(
                    f"ServeEngine({name}=...) is not ported yet; the port "
                    "serves dense slots (ROADMAP.md queue 1)")
        if cfg is None:
            if plan is None:
                raise ValueError("ServeEngine needs a ModelConfig or a "
                                 "SubspacePlan (which carries one)")
            cfg = plan.model
        self.plan = plan_of(cfg) if plan is None else _install(plan)
        check_layout(params.groups, self.plan)
        self.device = resolve_device(device)
        for p in params.parameters():
            if p.device != self.device:
                raise ValueError(f"params live on {p.device}, the engine "
                                 f"serves on {self.device}")
            break
        self.params = params
        self.cfg = cfg
        self.max_slots = max_slots
        self.max_cache = max_cache
        self.sched: Scheduler = (make_scheduler(scheduler)
                                 if isinstance(scheduler, str) else scheduler)
        self.quantized = self.plan.is_quantized
        from repro_torch.utils.memprof import model_weight_bytes
        self.weight_report = model_weight_bytes(params.tree())
        self.buckets = tuple(sorted(buckets))
        self.paged = False
        self.caches = init_lm_cache(cfg, max_slots, max_cache,
                                    dtype=_dtype(cfg.dtype),
                                    device=self.device)
        self.slots: list[Request | None] = [None] * max_slots
        # per-slot decode state, row-aligned with the cache batch axis
        self.pos = np.zeros(max_slots, np.int64)
        self.next_tok = np.zeros(max_slots, np.int64)
        self.temp = np.zeros(max_slots, np.float32)
        self.top_k = np.zeros(max_slots, np.int64)
        self.top_p = np.ones(max_slots, np.float32)
        self.seed = np.zeros(max_slots, np.uint32)
        self.count = np.zeros(max_slots, np.int64)
        self._rid = 0
        self.stats = {"prefill_tokens": 0, "decode_steps": 0,
                      "decode_tokens": 0, "completed": 0, "cancelled": 0,
                      "evicted": 0, "wall_s": 0.0, "prefill_s": 0.0,
                      "decode_s": 0.0}

    @classmethod
    def from_checkpoint(cls, ckpt_dir: str, step: int | None = None,
                        **engine_kw) -> "ServeEngine":
        """An engine from a plan-bearing checkpoint, no config in hand: the
        manifest's SubspacePlan carries the ModelConfig and each site's
        layout, quant stamps included, so an int8 checkpoint saved after
        ``convert.quantize`` serves int8 with no extra flag. The params go
        to ``engine_kw["device"]`` (default CUDA)."""
        from repro_torch.api.bridge import from_reference
        from repro_torch.api.convert import load_checkpoint

        tree, plan, _ = load_checkpoint(ckpt_dir, step)
        if plan is None:
            raise ValueError(
                f"checkpoint at {ckpt_dir} carries no SubspacePlan; build "
                "the engine with ServeEngine(params, cfg) instead")
        _install(plan)
        model = from_reference(tree, plan.model, engine_kw.get("device"))
        return cls(model, plan=plan, **engine_kw)

    # -- submission / cancellation ------------------------------------------

    def submit(self, prompt: Sequence[int], max_new: int | None = None,
               eos_id: int | None = None, *,
               sampling: SamplingParams | None = None,
               tenant: str | None = None) -> GenerationHandle:
        """Queue a generation; returns its :class:`GenerationHandle`."""
        sp = (sampling or SamplingParams()).resolved(
            self._rid, max_new=max_new, eos_id=eos_id)
        if tenant is not None:
            raise ValueError(
                "engine has no adapter banks; build it with "
                "adapters=<ResidentAdapters or store dir>")
        if len(prompt) + sp.max_new > self.max_cache:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new ({sp.max_new}) exceeds "
                f"max_cache ({self.max_cache})")
        if len(prompt) < 1:
            raise ValueError("empty prompt")
        req = Request(rid=self._rid, prompt=list(map(int, prompt)),
                      sampling=sp, submitted_at=time.perf_counter())
        self._rid += 1
        self.sched.add(req)
        return GenerationHandle(self, req)

    def cancel(self, rid: int) -> bool:
        """Cancel a queued or running request; a running one frees its
        slot at once. False if the rid is unknown or already terminal."""
        queued = self.sched.remove(rid)
        if queued is not None:
            self._retire(queued, EventKind.CANCELLED, "user cancel")
            return True
        for slot, req in enumerate(self.slots):
            if req is not None and req.rid == rid:
                self._free_slot(slot)
                self._retire(req, EventKind.CANCELLED, "user cancel")
                return True
        return False

    @property
    def busy(self) -> bool:
        """True while any request is queued or occupying a slot."""
        return bool(len(self.sched)) or any(r is not None for r in self.slots)

    # -- internals ----------------------------------------------------------

    def _free_slot(self, slot: int) -> None:
        """Recycle a slot and reset its sampling row to greedy."""
        self.slots[slot] = None
        self.temp[slot] = 0.0
        self.top_k[slot] = 0
        self.top_p[slot] = 1.0

    def _emit_token(self, req: Request, token: int, t: float) -> None:
        req.generated.append(token)
        if not req.first_token_at:
            req.first_token_at = t
        req.last_token_at = t
        req.events.append(Event(EventKind.TOKEN, req.rid, token=token, t=t))

    def _retire(self, req: Request, kind: EventKind, reason: str) -> None:
        t = time.perf_counter()
        req.events.append(Event(kind, req.rid, reason=reason, t=t))
        req.status = kind
        req.finished_at = t
        key = {EventKind.FINISHED: "completed",
               EventKind.CANCELLED: "cancelled",
               EventKind.EVICTED: "evicted"}[kind]
        self.stats[key] += 1

    def _finish_if_done(self, slot: int) -> None:
        req = self.slots[slot]
        if req is not None and req.hit_stop:
            self._free_slot(slot)
            s = req.sampling
            reason = ("eos" if s.eos_id is not None and req.generated
                      and req.generated[-1] == s.eos_id else "max_new")
            self._retire(req, EventKind.FINISHED, reason)

    def _evict(self, now: float) -> None:
        running = [r for r in self.slots if r is not None]
        for req in self.sched.victims(running, now):
            if req.terminal:
                continue
            for slot, r in enumerate(self.slots):
                if r is req:
                    self._free_slot(slot)
                    break
            self._retire(req, EventKind.EVICTED, "deadline")

    def _set_sampling_row(self, slot: int, req: Request) -> None:
        sp = req.sampling
        self.temp[slot] = sp.temperature
        self.top_k[slot] = sp.top_k
        self.top_p[slot] = sp.top_p
        self.seed[slot] = np.uint32(sp.seed & 0xFFFFFFFF)

    def _prefill(self, toks: np.ndarray, vlen: np.ndarray,
                 rows: np.ndarray) -> np.ndarray:
        """Prefill one bucket group: gather its cache rows, prefill them
        as one batch, scatter back; sample each row's first token."""
        dev = self.device
        rows_t = torch.as_tensor(rows, device=dev)
        sub = map_states(lambda a: a[:, rows_t], self.caches)
        logits, sub = lm_prefill(self.params, torch.as_tensor(toks,
                                                              device=dev),
                                 self.cfg, caches=sub,
                                 valid_len=torch.as_tensor(vlen, device=dev),
                                 last_only=True)
        for full, part in zip(_tree_leaves(self.caches), _tree_leaves(sub)):
            full[:, rows_t] = part
        first = sample_tokens(logits[:, 0], self.temp[rows], self.top_k[rows],
                              self.top_p[rows], self.seed[rows],
                              np.zeros(len(rows), np.int64))
        return first.cpu().numpy()

    def _admit_dense(self) -> None:
        free = [i for i, r in enumerate(self.slots) if r is None]
        if not free or not len(self.sched):
            return
        t0 = time.perf_counter()
        admitted: list[tuple[int, Request]] = []
        while free:
            req = self.sched.pop(t0)
            if req is None:
                break
            if req.terminal:
                continue
            admitted.append((free.pop(0), req))
        # group by bucket so same-shape prompts prefill as one batch
        groups: dict[int, list[tuple[int, Request]]] = \
            collections.defaultdict(list)
        for slot, req in admitted:
            groups[bucket_for(len(req.prompt), self.buckets,
                              self.max_cache)].append((slot, req))
        for bucket, group in groups.items():
            rows = np.array([s for s, _ in group], np.int64)
            vlen = np.array([len(r.prompt) for _, r in group], np.int64)
            toks = np.zeros((len(group), bucket), np.int64)
            for i, (slot, req) in enumerate(group):
                toks[i, :len(req.prompt)] = req.prompt
                self._set_sampling_row(slot, req)
            first = self._prefill(toks, vlen, rows)
            now = time.perf_counter()
            for i, (slot, req) in enumerate(group):
                self.slots[slot] = req
                self._emit_token(req, int(first[i]), now)
                self.pos[slot] = int(vlen[i])
                self.next_tok[slot] = int(first[i])
                self.count[slot] = 1
                self.stats["prefill_tokens"] += int(vlen[i])
                self._finish_if_done(slot)
        self.stats["prefill_s"] += time.perf_counter() - t0

    def _decode_all(self) -> None:
        active = [i for i, r in enumerate(self.slots) if r is not None]
        if not active:
            return
        t0 = time.perf_counter()
        dev = self.device
        logits, self.caches = lm_decode_step(
            self.params, torch.as_tensor(self.next_tok[:, None], device=dev),
            self.caches, torch.as_tensor(self.pos, device=dev), self.cfg)
        nxt = sample_tokens(logits, self.temp, self.top_k, self.top_p,
                            self.seed, self.count).cpu().numpy()
        self.stats["decode_steps"] += 1
        now = time.perf_counter()
        for slot in active:
            req = self.slots[slot]
            self._emit_token(req, int(nxt[slot]), now)
            self.pos[slot] += 1
            self.next_tok[slot] = int(nxt[slot])
            self.count[slot] += 1
            self.stats["decode_tokens"] += 1
            self._finish_if_done(slot)
        self.stats["decode_s"] += time.perf_counter() - t0

    # -- driving ------------------------------------------------------------

    def step(self) -> None:
        """One engine tick: enforce deadlines, admit whatever fits, then
        decode every active slot by one token."""
        t0 = time.perf_counter()
        with torch.inference_mode():
            self._evict(t0)
            self._admit_dense()
            self._decode_all()
        self.stats["wall_s"] += time.perf_counter() - t0

    def run(self) -> None:
        """Drain queue + slots to completion."""
        while self.busy:
            self.step()

    # -- reporting ----------------------------------------------------------

    def reset_stats(self) -> None:
        """Zero all counters/timers (e.g. after warmup runs)."""
        for k in self.stats:
            self.stats[k] = type(self.stats[k])()

    def cache_bytes(self) -> int:
        """Device bytes of the decode caches (slots x max_cache per layer,
        and every Mamba-2 layer's SSM state and conv buffers)."""
        from repro_torch.utils.memprof import array_bytes
        return int(sum(array_bytes(a) for a in _tree_leaves(self.caches)))

    def summary(self) -> dict:
        """Counters plus derived rates. Phase throughputs use each phase's
        own wall time; requests_s uses total engine time."""
        s = dict(self.stats)
        s["prefill_tok_s"] = s["prefill_tokens"] / max(s["prefill_s"], 1e-9)
        s["decode_tok_s"] = s["decode_tokens"] / max(s["decode_s"], 1e-9)
        s["requests_s"] = s["completed"] / max(s["wall_s"], 1e-9)
        s["weight_bytes"] = self.weight_report["total_bytes"]
        s["weight_mib"] = self.weight_report["total_bytes"] / 2**20
        s["quantized"] = self.quantized
        s["scheduler"] = getattr(self.sched, "name", type(self.sched).__name__)
        s["paged"] = False
        s["cache_bytes"] = self.cache_bytes()
        s["device"] = str(self.device)
        return s
