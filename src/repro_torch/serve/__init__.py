"""Request-level serving (port of ``repro.serve``): the continuous-
batching engine over dense slots or a paged KV pool with refcounted
prefix sharing and chunked prefill (kvpool.py), self-speculative
decoding (``spec_k > 0``: drafts through a cheap subspace view of the same
weights, verified in one forward with the rejection rule of
``sampling.spec_accept``), device-side sampling, streaming handles and
pluggable schedulers."""

from repro_torch.serve.engine import (
    DEFAULT_BUCKETS,
    DEFAULT_PAGE_SIZE,
    ServeEngine,
    bucket_for,
)
from repro_torch.serve.kvpool import PagePool, RadixCache, pages_needed
from repro_torch.serve.sampling import (
    SamplingParams,
    sample_draft_tokens,
    sample_tokens,
    spec_accept,
    warped_probs,
)
from repro_torch.serve.scheduler import (
    FCFS,
    SCHEDULERS,
    PriorityDeadline,
    Scheduler,
    ShortestPromptFirst,
    make_scheduler,
)
from repro_torch.serve.session import Event, EventKind, GenerationHandle, Request

__all__ = [
    "DEFAULT_BUCKETS",
    "DEFAULT_PAGE_SIZE",
    "Event",
    "EventKind",
    "FCFS",
    "GenerationHandle",
    "PagePool",
    "PriorityDeadline",
    "RadixCache",
    "Request",
    "SCHEDULERS",
    "SamplingParams",
    "Scheduler",
    "ServeEngine",
    "ShortestPromptFirst",
    "bucket_for",
    "make_scheduler",
    "pages_needed",
    "sample_draft_tokens",
    "sample_tokens",
    "spec_accept",
    "warped_probs",
]
