"""Device-resident LRU of tenant adapter banks for mixed-tenant serving.
Port of ``repro.tenancy.resident``.

The banks are ONE tree whose leaves carry a tenant axis of fixed size
``capacity + 1`` (row 0 is the all-zeros identity of adapter-less slots),
on the serving device. The serve engine hands each call the per-slot row
indices, and each stamped site gathers its slots' rows when it runs
(``adapter.SlotAdapters``), so admitting a tenant is an
``AdapterStore.load`` plus a ``set_bank_row`` written IN PLACE: the
banks' storage, shapes and dtype never change.

Eviction is LRU over rows 1..capacity with PINNING: the engine pins the
rows of every slot still generating, so a tenant mid-decode never has its
factors swapped out from under it. ``acquire`` returns ``None`` when every
row is pinned; the engine then defers that request to the next admission
tick instead of blocking.

The banks are built at ``__init__`` from the store's first adapter, so
their structure is fixed before the engine serves anything.
"""
from __future__ import annotations

from typing import Callable

from repro_torch.tenancy.adapter import (
    make_banks,
    set_bank_row,
    tree_leaves,
    tree_map,
)
from repro_torch.tenancy.store import AdapterStore
from repro_torch.utils.device import resolve_device


class ResidentAdapters:
    """LRU cache of ``capacity`` tenant adapter rows on ``device``
    (default CUDA). ``on_evict(tenant)`` fires when a resident tenant is
    displaced; the engine routes it into its EVICTED events."""

    def __init__(self, store: AdapterStore | str, capacity: int = 4, *,
                 on_evict: Callable[[str], None] | None = None,
                 device=None):
        self.store = AdapterStore(store) if isinstance(store, str) else store
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1: {capacity}")
        names = self.store.tenants()
        if not names:
            raise ValueError(f"adapter store {self.store.root!r} is empty; "
                             "banks need at least one adapter for shapes")
        self.device = resolve_device(device)
        self.capacity = int(capacity)
        self.on_evict = on_evict
        template, meta = self.store.load(names[0])
        self.plan_sha: str = meta["plan_sha"]
        self.plan_json: dict = meta["plan"]
        self.banks = make_banks(template, self.capacity, device=self.device)
        self._zero_row = tree_map(lambda t: t.new_zeros(t.shape), template)
        self.row_of: dict[str, int] = {}      # tenant -> row (1-based)
        self.tenant_of: dict[int, str] = {}   # row -> tenant
        self._last_used: dict[int, int] = {}  # row -> tick
        self._tick = 0
        self.hits = 0
        self.swaps = 0
        self.evictions = 0

    def resident(self) -> list[str]:
        return [self.tenant_of[r] for r in sorted(self.tenant_of)]

    def bank_bytes(self) -> int:
        return sum(x.numel() * x.element_size()
                   for x in tree_leaves(self.banks))

    def tenant_bytes(self, tenant: str) -> int:
        return int(self.store.meta(tenant)["bytes"])

    def acquire(self, tenant: str,
                pinned: set[int] = frozenset()) -> int | None:
        """Row index for ``tenant``, loading and evicting as needed.
        ``pinned`` rows (slots still generating) are never evicted. Returns
        ``None`` when the tenant is not resident and every row is pinned
        (the caller defers). A tenant the store has never seen raises."""
        self._tick += 1
        row = self.row_of.get(tenant)
        if row is not None:
            self.hits += 1
            self._last_used[row] = self._tick
            return row
        row = self._victim(pinned)
        if row is None:
            return None
        old = self.tenant_of.pop(row, None)
        if old is not None:
            del self.row_of[old]
            self.evictions += 1
            if self.on_evict is not None:
                self.on_evict(old)
        tree, _ = self.store.load(tenant, expect_plan_sha=self.plan_sha)
        set_bank_row(self.banks, row, tree)
        self.row_of[tenant] = row
        self.tenant_of[row] = tenant
        self._last_used[row] = self._tick
        self.swaps += 1
        return row

    def _victim(self, pinned: set[int]) -> int | None:
        for row in range(1, self.capacity + 1):      # a free row first
            if row not in self.tenant_of and row not in pinned:
                return row
        lru = [r for r in self.tenant_of if r not in pinned]
        if not lru:
            return None
        return min(lru, key=lambda r: self._last_used.get(r, 0))

    def drop(self, tenant: str) -> None:
        """Forget a tenant and zero its row, so a stale gather can never
        read its factors."""
        row = self.row_of.pop(tenant, None)
        if row is None:
            return
        del self.tenant_of[row]
        self._last_used.pop(row, None)
        set_bank_row(self.banks, row, self._zero_row)

    def summary(self) -> dict:
        return {
            "capacity": self.capacity,
            "resident": self.resident(),
            "bank_bytes": self.bank_bytes(),
            "store_tenants": len(self.store.tenants()),
            "hits": self.hits,
            "swaps": self.swaps,
            "evictions": self.evictions,
        }
