"""Continuous-batching serve engine over a fixed slot pool, with an
optional paged KV pool, radix prefix sharing and chunked prefill. Port of
``repro.serve.engine``.

* DENSE mode (``paged=False``, the oracle path): ONE set of batched decode
  caches (``init_lm_cache`` with batch = max_slots: KV caches, and for
  Mamba layers the SSM state and conv buffers). A slot is a batch row:
  admitting a request prefills its prompt into that row, finishing (or
  cancelling, or evicting) frees the row for the next queued request.
  Prefill is token-parallel (``lm_prefill``): admitted prompts are
  right-padded to bucket lengths and same-bucket admissions prefill
  together as one batch (rows gathered out of the caches, prefilled,
  scattered back).
* PAGED mode (``paged=True``, or ``"auto"`` where ``supports_paging``):
  KV storage is a pool of fixed-size pages (``serve/kvpool.py`` owns
  refcounts and the free list; ``nn/attention.py::PagedKVCache`` is the
  device side). Each slot maps logical pages to physical ones through a
  page-table row, so live slots decouple from ``max_cache``: a 12-token
  prompt holds pages for 12 + max_new tokens, not max_cache. A radix tree
  over prompt prefixes lets a shared system prompt prefill ONCE: later
  requests attach its pages by refcount and prefill only their suffix.
  Prefill is CHUNKED: at most ``prefill_chunks_per_tick`` chunks of
  ``(1, prefill_chunk)`` tokens advance per tick (every
  ``prefill_every``-th tick while decodes run), interleaved with the
  decode tick, so one long prompt cannot spike every other request's
  TPOT. Paged mode needs causal full attention in every layer; a config
  with sliding-window or Mamba layers serves dense (``"auto"``) or
  raises (``True``).
* Decode runs ALL slots every tick at per-slot positions (``pos`` a (B,)
  vector). Free (and, paged, still-prefilling) slots ride along as dead
  rows: dense dead rows keep writing K/V at their stale positions, which
  the causal masks never read back; paged dead rows carry an all-trash
  page-table row, so their writes land on page 0.
* Sampling runs on the device (``serve/sampling.py``); only the (B,)
  sampled tokens reach the host each tick.

* An int8 deployment (``plan.quantized("int8")`` with
  ``convert.quantize``) serves through the same engine, dense or paged:
  every factored linear then runs the int8 kernel
  (``kernels/csrc/lowrank_q8.cu``), and ``summary()`` reports
  ``quantized`` and the packed ``weight_bytes``.
  ``ServeEngine.from_checkpoint`` builds the engine from a plan-bearing
  checkpoint with no config in hand.

* Self-speculative decoding (``spec_k > 0``): each decode tick drafts
  ``spec_k`` tokens through a cheap view of the SAME weights (``draft=``
  ``"int8"``: the factors packed to int8, kernel #6; ``"rank:<frac>"``:
  the leading columns of each L and rows of each R, read in place by
  kernel #1's decode route), then verifies them all in one forward of the
  full factors (``lm_prefill`` at per-row offsets) and applies the
  rejection rule on the device (``sampling.spec_accept``): greedy rows
  emit exactly the non-spec tokens, sampled rows the target's
  distribution. Rows done drafting are parked at ``pos == max_cache``:
  dense ones write nothing (``valid_len`` 0), paged ones write to an
  extra all-trash column of the table. Paged slots may hold pages past
  their admission reservation for a tick (``_spec_pages``), returned at
  its end (``_spec_release``).

* Tenant adapters (``adapters=``: a ``tenancy.ResidentAdapters`` or an
  ``AdapterStore`` directory): ``submit(tenant=...)`` routes a request
  through that tenant's rank-K_a delta. Each slot carries a row of the
  device-resident banks (``adapter_ix``; row 0, the zero identity, for no
  tenant), acquired at admission with the rows of running slots pinned
  (a request whose tenant finds every row pinned waits for the next
  admission tick: ``deferred``). Every prefill, chunk and decode call runs
  a ``tenancy.SlotAdapters`` view of the model, whose stamped sites gather
  their slots' rows when they run (``bind.adapter_delta``, a ``bmm``
  pair), one site at a time. LRU displacements land in
  ``adapter_events`` as EVICTED events (rid -1). Paged prefix sharing is
  namespaced by tenant: a prefix's K/V under one adapter is not the same
  K/V under another. Adapters need an f32 model, and exclude speculative
  decoding, as in the reference.

Where the reference jits and donates the caches, this engine runs eager
PyTorch under ``torch.inference_mode()`` and updates the caches in place.
Not ported yet (it raises ``NotImplementedError``): mesh serving.
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
    supports_paging,
)
from repro_torch.serve.kvpool import PagePool, RadixCache, pages_needed
from repro_torch.serve.sampling import (
    SamplingParams,
    sample_draft_tokens,
    sample_tokens,
    spec_accept,
)
from repro_torch.serve.scheduler import Scheduler, make_scheduler
from repro_torch.serve.session import Event, EventKind, GenerationHandle, Request
from repro_torch.utils.device import resolve_device

DEFAULT_BUCKETS = (8, 16, 32, 64, 128, 256)
DEFAULT_PAGE_SIZE = 16


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


def paged_chunk_prefill(params, cfg: ModelConfig, caches,
                        prompt: Sequence[int], cur: int, chunk: int,
                        table_row: np.ndarray, page_size: int, device):
    """One chunk of a paged prefill: prompt tokens ``[cur, end)``, end =
    min(cur + chunk, len(prompt)), right-padded to ``(1, chunk)``, through
    ``lm_prefill`` at offset ``cur``, reading and writing the slot's pages
    through ``table_row`` (pages_per_slot,). Returns (logits (1, 1, V) of
    the chunk's last valid row, end).

    The table is sliced to a power-of-2 HISTORY bucket: the chunk attends
    (and writes) only positions < end, and masked columns contribute
    exactly 0, so early chunks of a long prompt cost O(history so far).
    The chunk's padded rows lie past ``end`` and so may lie past this
    slice: ``_page_ids`` in nn/attention.py routes them to the trash page
    before indexing."""
    end = min(cur + chunk, len(prompt))
    toks = np.zeros((1, chunk), np.int64)
    toks[0, :end - cur] = prompt[cur:end]
    n_hist = min(len(table_row),
                 1 << (pages_needed(end, page_size) - 1).bit_length())
    logits, _ = lm_prefill(
        params, torch.as_tensor(toks, device=device), cfg, caches=caches,
        pos=torch.tensor([cur], device=device),
        valid_len=torch.tensor([end - cur], device=device), last_only=True,
        page_table=torch.as_tensor(table_row[None, :n_hist], device=device))
    return logits, end


def _tree_leaves(caches):
    """Every cache tensor (KV, SSM state, both conv buffers), in one
    order."""
    out = []
    map_states(out.append, caches)
    return out


def _extra_bytes(draft: LanguageModel, target: LanguageModel) -> int:
    """Bytes of the draft's leaves that live in no storage of the target:
    0 for a rank draft (views), the packed copy for an int8 one."""
    held = {p.untyped_storage().data_ptr() for p in target.parameters()}
    return sum(p.numel() * p.element_size() for p in draft.parameters()
               if p.untyped_storage().data_ptr() not in held)


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
                 paged: bool | str = False,
                 page_size: int = DEFAULT_PAGE_SIZE,
                 total_pages: int | None = None,
                 prefix_cache: bool = True,
                 prefill_chunk: int | None = None,
                 prefill_chunks_per_tick: int = 1,
                 prefill_every: int = 1,
                 spec_k: int = 0, draft: str = "int8", adapters=None,
                 adapter_slots: int = 4, mesh=None, device=None):
        if mesh:
            raise NotImplementedError(
                "ServeEngine(mesh=...) is not ported yet; the port serves "
                "dense and paged slots on one device (ROADMAP.md queue 1)")
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

        # self-speculative decoding: spec_k tokens drafted a tick through
        # a cheap view of the SAME weights, verified in one forward
        self.spec_k = int(spec_k)
        self.draft_source = draft
        self.draft_params = None
        self.draft_extra_bytes = 0
        if self.spec_k:
            if self.spec_k > max_cache - 2:
                raise ValueError(f"spec_k ({spec_k}) leaves no room in "
                                 f"max_cache ({max_cache})")
            if not supports_paging(cfg):
                # rolling-window and recurrent caches update destructively:
                # a rejected draft could not be rolled back
                raise ValueError(
                    f"config {cfg.name!r} has sliding-window or recurrent "
                    "layers whose caches cannot roll back rejected drafts; "
                    "speculative decoding needs causal full attention")
            if draft == "int8" and self.quantized:
                raise ValueError(
                    "engine already serves int8: an int8 draft would equal "
                    "the target; use draft='rank:<frac>' to slice the "
                    "resident int8 factors instead")
            # the stamp lets bind.apply take the draft's layouts (int8
            # params under an f32 spec); it never changes the verify pass,
            # so it may replace an installed unstamped plan
            stamped = self.plan.with_draft(draft)
            if stamped.draft_source is None:
                raise ValueError(
                    f"draft {draft!r} stamps no site of this plan (rank "
                    "drafts need factored sites: a dense-only plan has "
                    "nothing to slice)")
            if stamped != self.plan:
                self.plan = install(stamped)
            from repro_torch.api.convert import draft_view
            self.draft_params = draft_view(params, self.plan)
            self.draft_extra_bytes = _extra_bytes(self.draft_params, params)

        # tenant adapter banks: each call's slots gather their rows per
        # site from the device-resident banks (SlotAdapters), so any mix
        # of tenants, adapter-less slots included, runs one path, and
        # tenant churn rewrites bank rows in place
        self.adapters = self.adapter_plan = self._served = None
        self.adapter_events: list[Event] = []
        if adapters is not None:
            self._init_adapters(adapters, adapter_slots)

        if paged == "auto":
            paged = supports_paging(cfg)
        elif paged and not supports_paging(cfg):
            raise ValueError(
                f"config {cfg.name!r} has layers a paged KV pool cannot hold "
                "(sliding-window or recurrent state); serve it dense or use "
                "paged='auto'")
        self.paged = bool(paged)
        dtype = _dtype(cfg.dtype)
        if self.paged:
            self.page_size = int(page_size)
            self.pages_per_slot = pages_needed(max_cache, page_size)
            if total_pages is None:
                # dense-equivalent capacity by default; pass fewer pages to
                # oversubscribe slots, or more to grow the prefix cache
                total_pages = max_slots * self.pages_per_slot + 1
            self.pool = PagePool(total_pages, page_size)
            self.radix = RadixCache(self.pool) if prefix_cache else None
            self.prefill_chunk = int(prefill_chunk or self.buckets[-1])
            self.prefill_chunks_per_tick = int(prefill_chunks_per_tick)
            # stride: with decodes active, advance prefill only every Nth
            # tick; each chunk attends over the gathered history, so on
            # long prompts a chunk can cost several decode ticks, and the
            # stride bounds its TPOT tax at the price of long-request TTFT
            self.prefill_every = max(1, int(prefill_every))
            self._tick = 0
            self.caches = init_lm_cache(cfg, max_slots, max_cache,
                                        dtype=dtype, device=self.device,
                                        pages=total_pages,
                                        page_size=page_size)
            # host-side slot state: page-table rows, per-slot page lists,
            # and the prefill cursor (absolute position of the next
            # unprefilled prompt token; None = not prefilling)
            self.tables = np.zeros((max_slots, self.pages_per_slot),
                                   np.int64)
            self.slot_pages: list[list[int]] = [[] for _ in range(max_slots)]
            self._cursor: list[int | None] = [None] * max_slots
            self._pf_rr = 0
            # pages reserved at admission (pages_needed(prompt + max_new));
            # a spec tick may hold pages past it for the draft's and the
            # verify's writes, and returns them at its end (_spec_release)
            self._prealloc = [0] * max_slots
        else:
            self.pool = self.radix = None
            self.caches = init_lm_cache(cfg, max_slots, max_cache,
                                        dtype=dtype, device=self.device)
        self.slots: list[Request | None] = [None] * max_slots
        # per-slot decode state, row-aligned with the cache batch axis
        self.pos = np.zeros(max_slots, np.int64)
        self.next_tok = np.zeros(max_slots, np.int64)
        # per-slot adapter bank row (0 = identity, no tenant)
        self.adapter_ix = np.zeros(max_slots, np.int64)
        self.temp = np.zeros(max_slots, np.float32)
        self.top_k = np.zeros(max_slots, np.int64)
        self.top_p = np.ones(max_slots, np.float32)
        self.seed = np.zeros(max_slots, np.uint32)
        self.count = np.zeros(max_slots, np.int64)
        self._rid = 0
        self.stats = {"prefill_tokens": 0, "prefill_chunks": 0,
                      "prefix_hit_tokens": 0, "decode_steps": 0,
                      "decode_tokens": 0, "completed": 0, "cancelled": 0,
                      "evicted": 0, "deferred": 0, "wall_s": 0.0,
                      "prefill_s": 0.0, "decode_s": 0.0,
                      "spec_steps": 0, "spec_draft_tokens": 0,
                      "spec_accepted_tokens": 0, "spec_page_shrinks": 0,
                      "adapter_evictions": 0}

    def _init_adapters(self, adapters, capacity: int) -> None:
        from repro_torch.models.lm import _dtype
        from repro_torch.tenancy.adapter import (
            SlotAdapters,
            check_dtype,
            tree_leaves,
        )
        from repro_torch.tenancy.resident import ResidentAdapters

        if self.spec_k:
            raise ValueError(
                "speculative decoding and tenant adapters are mutually "
                "exclusive: the draft view does not carry per-tenant "
                "deltas, so drafts would systematically diverge")
        if isinstance(adapters, str):
            adapters = ResidentAdapters(adapters, capacity=capacity,
                                        device=self.device)
        stamped = SubspacePlan.from_json(adapters.plan_json)
        if stamped.model != self.cfg:
            raise ValueError(
                f"adapter store was trained for model "
                f"{stamped.model.name!r} but the engine serves "
                f"{self.cfg.name!r}")
        banks = tree_leaves(adapters.banks)
        check_dtype(_dtype(self.cfg.dtype), banks[0].dtype)
        if banks[0].device != self.device:
            raise ValueError(f"adapter banks live on {banks[0].device}, the "
                             f"engine serves on {self.device}")
        self.adapters = adapters
        self.adapter_plan = stamped
        adapters.on_evict = self._adapter_evicted
        self._served = SlotAdapters(self.params, adapters.banks)

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
            if self.adapters is None:
                raise ValueError(
                    "engine has no adapter banks; build it with "
                    "adapters=<ResidentAdapters or store dir>")
            if not self.adapters.store.has(tenant):
                raise ValueError(f"unknown tenant {tenant!r}: no adapter "
                                 f"in store {self.adapters.store.root!r}")
        if len(prompt) + sp.max_new > self.max_cache:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new ({sp.max_new}) exceeds "
                f"max_cache ({self.max_cache})")
        if len(prompt) < 1:
            raise ValueError("empty prompt")
        if self.paged:
            need = pages_needed(len(prompt) + sp.max_new, self.page_size)
            if need > self.pool.usable_pages:
                raise ValueError(
                    f"request needs {need} pages but the pool has "
                    f"{self.pool.usable_pages} usable (total_pages too "
                    "small for this prompt + max_new)")
        req = Request(rid=self._rid, prompt=list(map(int, prompt)),
                      sampling=sp, tenant=tenant,
                      submitted_at=time.perf_counter())
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

    # -- paged-pool maintenance ---------------------------------------------

    def release_prefix_cache(self) -> int:
        """Drop every radix-held page (frees them back to the pool).
        Returns the number of pages released. After a full drain plus this
        call, every page refcount is zero."""
        return self.radix.clear() if self.radix is not None else 0

    def check_invariants(self) -> None:
        """Audit the paged bookkeeping (no-op in dense mode): the pool's
        structure is sound and every page's refcount equals its holder
        count (slots holding it in their table + radix nodes)."""
        if not self.paged:
            return
        self.pool.check()
        expected = np.zeros(self.pool.total_pages, np.int64)
        for slot, pages in enumerate(self.slot_pages):
            if self.slots[slot] is not None:
                for p in pages:
                    expected[p] += 1
        if self.radix is not None:
            for p in self.radix.held_pages():
                expected[p] += 1
        actual = self.pool.refs.astype(np.int64)
        if not (expected == actual).all():
            bad = np.nonzero(expected != actual)[0]
            raise AssertionError(
                f"page refcount leak: pages {bad.tolist()} expected "
                f"{expected[bad].tolist()} got {actual[bad].tolist()}")

    # -- internals ----------------------------------------------------------

    def _adapter_evicted(self, tenant: str) -> None:
        """A bank row's LRU displacement, as an EVICTED event (rid -1: no
        one request owns a bank row)."""
        self.adapter_events.append(Event(
            EventKind.EVICTED, rid=-1,
            reason=f"adapter lru tenant={tenant}", t=time.perf_counter()))
        self.stats["adapter_evictions"] += 1

    def _acquire_adapter(self, req: Request, admitted: list) -> int | None:
        """Bank row for this request's tenant (0 = identity). Rows held by
        slots still generating, and by requests admitted earlier this
        round (dense prefills them as one batch after the pop loop), are
        pinned. ``None``: every row is pinned; the caller defers."""
        if self.adapters is None or req.tenant is None:
            return 0
        pinned = {int(self.adapter_ix[s]) for s, r in enumerate(self.slots)
                  if r is not None}
        pinned.update(int(self.adapter_ix[s]) for s, _ in admitted)
        pinned.discard(0)
        return self.adapters.acquire(req.tenant, pinned)

    def _fwd(self, rows=None):
        """What a prefill, chunk or decode call runs: the model, or on an
        adapter engine its ``SlotAdapters`` view with the rows of the
        call's slots (``rows``; every slot when None)."""
        if self._served is None:
            return self.params
        ix = self.adapter_ix if rows is None else self.adapter_ix[rows]
        self._served.ix = torch.as_tensor(ix, device=self.device)
        return self._served

    def _free_slot(self, slot: int) -> None:
        """Recycle a slot and reset its sampling row to greedy. In paged
        mode also release the slot's page references and point its table
        row at the trash page, so the dead row's lockstep writes can never
        land in a page the pool hands to someone else."""
        self.slots[slot] = None
        self.adapter_ix[slot] = 0     # unpin the tenant's bank row
        self.temp[slot] = 0.0
        self.top_k[slot] = 0
        self.top_p[slot] = 1.0
        if self.paged:
            for p in self.slot_pages[slot]:
                self.pool.unref(p)
            self.slot_pages[slot] = []
            self.tables[slot, :] = 0
            self._cursor[slot] = None
            self._prealloc[slot] = 0

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
        logits, sub = lm_prefill(self._fwd(rows),
                                 torch.as_tensor(toks, device=dev),
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
            row = self._acquire_adapter(req, admitted)
            if row is None:
                self.sched.add(req)       # every bank row pinned: wait
                self.stats["deferred"] += 1
                break
            slot = free.pop(0)
            self.adapter_ix[slot] = row
            admitted.append((slot, req))
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

    def _admit_paged(self) -> None:
        """Admit queued requests into free slots by RESERVING pages; the
        prefill itself runs chunk by chunk in ``_prefill_tick``. The radix
        cache is consulted first: matched full-page prefixes attach by
        reference (refcount bump, no prefill) and the prefill cursor
        starts past them. A request the pool cannot satisfy, even after
        LRU eviction of unreferenced prefix-cache pages, goes back to the
        scheduler and admission stops for this tick: running requests
        free pages as they retire."""
        free = [i for i, r in enumerate(self.slots) if r is None]
        if not free or not len(self.sched):
            return
        t0 = time.perf_counter()
        pg = self.page_size
        while free:
            req = self.sched.pop(t0)
            if req is None:
                break
            if req.terminal:
                continue
            # paged admission fills self.slots inside the loop, so pinning
            # the running slots covers this round's admissions too
            row = self._acquire_adapter(req, [])
            if row is None:
                self.sched.add(req)        # every bank row pinned: wait
                self.stats["deferred"] += 1
                break
            prompt = req.prompt
            need = pages_needed(len(prompt) + req.sampling.max_new, pg)
            shared: list[int] = []
            if self.radix is not None:
                # cap the shared pages so at least ONE prompt token is left
                # to prefill: the final chunk must produce next-token
                # logits. Tenant-namespaced: a prefix prefilled under one
                # adapter is not the same K/V under another (or the base)
                shared = self.radix.match(
                    prompt, namespace=req.tenant)[:(len(prompt) - 1) // pg]
                for p in shared:       # protect from our own eviction below
                    self.pool.ref(p)
            fresh = need - len(shared)
            if self.pool.free_pages < fresh and self.radix is not None:
                self.radix.evict(fresh - self.pool.free_pages)
            alloc = self.pool.alloc(fresh)
            if alloc is None:
                for p in shared:
                    self.pool.unref(p)
                self.sched.add(req)        # not enough pages: wait
                self.stats["deferred"] += 1
                break
            slot = free.pop(0)
            self.adapter_ix[slot] = row
            pages = shared + alloc
            self.tables[slot, :] = 0
            self.tables[slot, :len(pages)] = pages
            self.slot_pages[slot] = pages
            self._prealloc[slot] = need
            self.slots[slot] = req
            self._set_sampling_row(slot, req)
            self._cursor[slot] = len(shared) * pg
            self.pos[slot] = 0
            self.count[slot] = 0
            self.stats["prefix_hit_tokens"] += len(shared) * pg
        self.stats["prefill_s"] += time.perf_counter() - t0

    def _prefill_tick(self) -> None:
        """Advance chunked prefill: up to ``prefill_chunks_per_tick``
        chunks across the slots currently prefilling, round-robin so a
        long prompt cannot starve a short one. Each chunk is one
        (1, prefill_chunk) call that writes K/V through the slot's page
        table; the final chunk samples the request's first token and
        publishes the prompt's full pages to the radix cache."""
        if not self.paged:
            return
        waiting = [s for s in range(self.max_slots)
                   if self.slots[s] is not None and self._cursor[s] is not None]
        if not waiting:
            return
        decoding = any(self.slots[s] is not None and self._cursor[s] is None
                       for s in range(self.max_slots))
        if decoding and self._tick % self.prefill_every:
            return      # the stride only matters when someone would starve
        t0 = time.perf_counter()
        order = sorted(waiting,
                       key=lambda s: (s - self._pf_rr) % self.max_slots)
        for slot in order[:self.prefill_chunks_per_tick]:
            self._pf_rr = (slot + 1) % self.max_slots
            req = self.slots[slot]
            cur = self._cursor[slot]
            rows = slice(slot, slot + 1)
            logits, end = paged_chunk_prefill(
                self._fwd([slot]), self.cfg, self.caches, req.prompt, cur,
                self.prefill_chunk, self.tables[slot], self.page_size,
                self.device)
            self.stats["prefill_tokens"] += end - cur
            self.stats["prefill_chunks"] += 1
            if end < len(req.prompt):
                self._cursor[slot] = end
                continue
            first = int(sample_tokens(
                logits[:, 0], self.temp[rows], self.top_k[rows],
                self.top_p[rows], self.seed[rows],
                np.zeros(1, np.int64)).cpu()[0])
            # prompt complete: publish full pages for prefix reuse, then
            # emit the sampled first token and hand the slot to decode
            self._cursor[slot] = None
            if self.radix is not None:
                n_full = len(req.prompt) // self.page_size
                self.radix.insert(req.prompt,
                                  self.slot_pages[slot][:n_full],
                                  namespace=req.tenant)
            self._emit_token(req, first, time.perf_counter())
            self.pos[slot] = len(req.prompt)
            self.next_tok[slot] = first
            self.count[slot] = 1
            self._finish_if_done(slot)
        self.stats["prefill_s"] += time.perf_counter() - t0

    def _decode_all(self) -> None:
        active = [i for i, r in enumerate(self.slots)
                  if r is not None and (not self.paged
                                        or self._cursor[i] is None)]
        if not active:
            return
        t0 = time.perf_counter()
        dev = self.device
        table = None
        if self.paged:
            # still-prefilling rows ride along dead: route their lockstep
            # writes to the trash page, not into pages their prefill owns
            tbl = self.tables.copy()
            for s in range(self.max_slots):
                if self._cursor[s] is not None:
                    tbl[s, :] = 0
            table = torch.as_tensor(tbl, device=dev)
        logits, self.caches = lm_decode_step(
            self._fwd(), torch.as_tensor(self.next_tok[:, None], device=dev),
            self.caches, torch.as_tensor(self.pos, device=dev), self.cfg,
            page_table=table)
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

    def _spec_pages(self, active: list[int]) -> np.ndarray:
        """Paged draft coverage: each active slot's draft length after
        making sure pages lie under every position the draft and the
        verify write (pos .. pos + draft_len). A draft near the end of its
        budget may need pages past the admission reservation (the verify
        block overruns prompt + max_new though emission never does): they
        are allocated here and returned by ``_spec_release`` the same
        tick. A pool that runs short shrinks the draft to the pages held
        (``spec_page_shrinks``) instead of deferring the tick."""
        draft_len = np.zeros(self.max_slots, np.int64)
        pg = self.page_size
        for slot in active:
            pos = int(self.pos[slot])
            dl = min(self.spec_k, self.max_cache - 1 - pos)
            need = pages_needed(pos + dl + 1, pg)
            have = len(self.slot_pages[slot])
            if need > have:
                want = need - have
                if self.pool.free_pages < want and self.radix is not None:
                    self.radix.evict(want - self.pool.free_pages)
                grab = min(want, self.pool.free_pages)
                alloc = self.pool.alloc(grab) if grab else None
                if alloc:
                    self.tables[slot, have:have + len(alloc)] = alloc
                    self.slot_pages[slot].extend(alloc)
                    have += len(alloc)
                if have < need:
                    dl = min(dl, have * pg - 1 - pos)
                    self.stats["spec_page_shrinks"] += 1
            draft_len[slot] = max(dl, 0)
        return draft_len

    def _spec_release(self) -> None:
        """Return every page past a live slot's admission reservation to
        the pool and zero its table tail: the rollback half of the paged
        draft. Emission stops at max_new, so the slot never needs them
        again; finished slots released everything in ``_free_slot``."""
        for slot, req in enumerate(self.slots):
            if req is None:
                continue
            keep = self._prealloc[slot]
            extra = self.slot_pages[slot][keep:]
            if not extra:
                continue
            for p in extra:
                self.pool.unref(p)
            self.slot_pages[slot] = self.slot_pages[slot][:keep]
            self.tables[slot, keep:] = 0

    def _draft_step(self, toks: torch.Tensor, i: int, draft_len: np.ndarray,
                    table) -> tuple:
        """Draft step ``i`` of a tick: one decode step of (B, 1) ``toks``
        under ``draft_params``, sampled from the ``SALT_DRAFT`` stream ->
        ((B,) proposals, (B, V) their warped q). Its K/V lands at pos + i
        and is overwritten by the verify; rows past their draft length
        write at ``max_cache`` (dense: masked by ``valid_len`` 0; paged:
        the table's trash column)."""
        dev = self.device
        live = i < draft_len
        pos = torch.as_tensor(np.where(live, self.pos + i, self.max_cache),
                              device=dev)
        valid = (None if self.paged else
                 torch.as_tensor(live.astype(np.int64), device=dev))
        logits, self.caches = lm_decode_step(
            self.draft_params, toks, self.caches, pos, self.cfg,
            page_table=table, valid_len=valid)
        return sample_draft_tokens(logits, self.temp, self.top_k, self.top_p,
                                   self.seed, self.count + i)

    def _verify(self, toks: torch.Tensor, draft_q: torch.Tensor,
                draft_len: np.ndarray, table) -> tuple:
        """ONE forward of the full factors over (B, k + 1) ``toks`` =
        [current, drafts] at each row's position (the dense verify branch,
        or chunked prefill through ``table``), its K/V overwriting the
        draft's, then the rejection rule on the device: host arrays
        (n_acc (B,), out (B, k + 1))."""
        dev = self.device
        with torch.profiler.record_function("spec_verify"):
            logits, self.caches = lm_prefill(
                self.params, toks, self.cfg, caches=self.caches,
                pos=torch.as_tensor(self.pos, device=dev),
                valid_len=torch.as_tensor(draft_len + 1, device=dev),
                page_table=table)
        with torch.profiler.record_function("spec_accept"):
            n_acc, out = spec_accept(
                logits.float(), toks[:, 1:], draft_q, draft_len, self.temp,
                self.top_k, self.top_p, self.seed, self.count)
            return n_acc.cpu().numpy(), out.cpu().numpy()

    def _spec_decode_all(self) -> None:
        """One speculative tick over every decoding slot: ``spec_k`` draft
        steps through ``draft_params``, one verify forward of the full
        factors over [current token, drafts] at each row's position, the
        rejection rule on the device; each row emits its accepted prefix
        and one corrected or bonus token (one device-to-host copy a tick).
        Draft lengths are capped by cache capacity only (max_cache - 1 -
        pos): the host stops emitting at max_new or EOS, and the overrun's
        K/V is never read (dense) or its pages are returned (paged). Dead
        and still-prefilling rows ride along at draft length 0, parked at
        ``pos == max_cache`` from the first draft step (their dense writes
        masked, their paged ones on the trash column), as in
        ``_decode_all``. The three parts run under profiler ranges
        ``spec_draft``, ``spec_verify``, ``spec_accept``."""
        active = [i for i, r in enumerate(self.slots)
                  if r is not None and (not self.paged
                                        or self._cursor[i] is None)]
        if not active:
            return
        t0 = time.perf_counter()
        k, dev = self.spec_k, self.device
        table = None
        if self.paged:
            draft_len = self._spec_pages(active)
            # dead and prefilling rows write to the trash page; every row
            # gets one more trash column, under position max_cache
            tbl = self.tables.copy()
            for s in range(self.max_slots):
                if self.slots[s] is None or self._cursor[s] is not None:
                    tbl[s, :] = 0
            table = torch.as_tensor(np.concatenate(
                [tbl, np.zeros((self.max_slots, 1), np.int64)], axis=1),
                device=dev)
        else:
            draft_len = np.zeros(self.max_slots, np.int64)
            for slot in active:
                draft_len[slot] = max(
                    0, min(k, self.max_cache - 1 - int(self.pos[slot])))
        cols = [torch.as_tensor(self.next_tok[:, None], device=dev)]
        qs = []
        with torch.profiler.record_function("spec_draft"):
            for i in range(k):
                nxt, q = self._draft_step(cols[-1], i, draft_len, table)
                cols.append(nxt[:, None])
                qs.append(q)
        n_acc, out = self._verify(torch.cat(cols, dim=1),
                                  torch.stack(qs, dim=1), draft_len, table)
        self.stats["decode_steps"] += 1
        self.stats["spec_steps"] += 1
        now = time.perf_counter()
        for slot in active:
            req = self.slots[slot]
            self.stats["spec_draft_tokens"] += int(draft_len[slot])
            self.stats["spec_accepted_tokens"] += int(n_acc[slot])
            req.accepted_counts.append(int(n_acc[slot]))
            emitted = 0
            for j in range(int(n_acc[slot]) + 1):
                self._emit_token(req, int(out[slot, j]), now)
                emitted += 1
                if req.hit_stop:
                    break
            self.pos[slot] += emitted
            self.next_tok[slot] = int(out[slot, emitted - 1])
            self.count[slot] += emitted
            self.stats["decode_tokens"] += emitted
            self._finish_if_done(slot)
        if self.paged:
            self._spec_release()
        self.stats["decode_s"] += time.perf_counter() - t0

    # -- driving ------------------------------------------------------------

    def step(self) -> None:
        """One engine tick: enforce deadlines, admit whatever fits, advance
        chunked prefill (paged mode), then decode every active slot by one
        token."""
        t0 = time.perf_counter()
        if self.paged:
            self._tick += 1
        with torch.inference_mode():
            self._evict(t0)
            if self.paged:
                self._admit_paged()
                self._prefill_tick()
            else:
                self._admit_dense()
            if self.spec_k:
                self._spec_decode_all()
            else:
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
        """Device bytes of the decode caches: dense reserves slots x
        max_cache per attention layer (and every Mamba layer's SSM state
        and conv buffers), paged total_pages x page_size per attention
        layer (``utils.memprof.kv_cache_bytes`` computes either from the
        config)."""
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
        s["paged"] = self.paged
        s["cache_bytes"] = self.cache_bytes()
        s["device"] = str(self.device)
        if self.paged:
            s["page_size"] = self.page_size
            s["total_pages"] = self.pool.total_pages
            s["pages_in_use"] = self.pool.pages_in_use
            s["prefix_cache_pages"] = (self.radix.n_nodes
                                       if self.radix is not None else 0)
        if self.adapters is not None:
            # the base-vs-adapter split: bank bytes are the per-tenant
            # device cost, store bytes the per-tenant disk cost
            t = self.adapters.summary()
            t["bytes_by_tenant"] = self.adapters.store.bytes_by_tenant()
            s["tenancy"] = t
            s["adapter_bank_bytes"] = t["bank_bytes"]
        if self.spec_k:
            s["spec_k"] = self.spec_k
            s["draft_source"] = self.draft_source
            s["acceptance_rate"] = (s["spec_accepted_tokens"]
                                    / max(s["spec_draft_tokens"], 1))
            # mean tokens emitted per verify (accepted + corrected/bonus)
            s["tokens_per_verify"] = (s["decode_tokens"]
                                      / max(s["spec_steps"], 1))
            s["draft_extra_bytes"] = self.draft_extra_bytes
        return s
