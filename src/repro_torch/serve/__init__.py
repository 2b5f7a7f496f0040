"""Request-level serving (port of ``repro.serve``): the continuous-
batching engine in dense-slot mode, device-side sampling, streaming
handles and pluggable schedulers."""

from repro_torch.serve.engine import DEFAULT_BUCKETS, ServeEngine, bucket_for
from repro_torch.serve.sampling import SamplingParams, sample_tokens
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
    "Event",
    "EventKind",
    "FCFS",
    "GenerationHandle",
    "PriorityDeadline",
    "Request",
    "SCHEDULERS",
    "SamplingParams",
    "Scheduler",
    "ServeEngine",
    "ShortestPromptFirst",
    "bucket_for",
    "make_scheduler",
    "sample_tokens",
]
