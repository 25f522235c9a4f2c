"""The pick-facing types of the ext-proc layer (from gie_tpu/extproc/server.py):
what a picker takes (PickRequest) and returns (PickResult), and the two
errors it raises.

They live apart from the StreamingServer loop (extproc/server.py, which
re-exports them) so that the pick service imports no protobuf or grpc.
ExtProcError carries its status by its gRPC name ("UNAVAILABLE",
"INVALID_ARGUMENT", "INTERNAL", "RESOURCE_EXHAUSTED"); the transport
(extproc/service.py) maps the name to a grpc.StatusCode.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

# The status names the pick path raises with.
UNAVAILABLE = "UNAVAILABLE"
INVALID_ARGUMENT = "INVALID_ARGUMENT"
INTERNAL = "INTERNAL"
RESOURCE_EXHAUSTED = "RESOURCE_EXHAUSTED"


class ExtProcError(Exception):
    """Stream-fatal protocol error -> gRPC status, by name."""

    def __init__(self, code: str, message: str):
        super().__init__(message)
        self.code = code
        self.message = message


class ShedError(Exception):
    """Request shed under load -> ImmediateResponse 429 (004 README:80).

    Band- and tenant-aware (gie_tpu/fairness): shed sites stamp WHO was
    shed so the response path, tests, and the storm scorecard can prove
    sheds land on the over-budget tenant's SHEDDABLE traffic, never on
    CRITICAL work while lower bands hold queued requests."""

    def __init__(self, message: str = "request shed",
                 band=None, tenant: str = ""):
        super().__init__(message)
        self.band = band
        self.tenant = tenant


@dataclasses.dataclass(slots=True)
class PickRequest:
    """reference handlers/server.go:65-69."""

    headers: dict[str, list[str]]
    body: Optional[bytes] = None
    model: str = ""
    # Expected output length in TOKENS (0 = unknown): the decode-tokens
    # header, else the body's max_tokens-style cap — the output-length
    # scheduling dimension of reference 006 README:27-36. Feeds
    # RequestBatch.decode_len (via CHARS_PER_TOKEN) so request_cost and
    # the pd decode-side cost see generation length on the live path.
    decode_tokens: float = 0.0
    # Monotonic request deadline (0.0 = none; resilience/deadline.py):
    # the batching collector sheds queued picks past this with 503.
    deadline_at: float = 0.0
    # Trace context (obs.trace.TraceCtx or None): rides the pick through
    # the flow queue and wave so the scheduler stages can stamp events
    # and the flight-recorder record carries the trace ID.
    trace: object = None
    # True when the candidate set came from an upstream subset filter /
    # test-endpoint header: a pinned set is honored verbatim — the
    # federation spill policy must never widen it (docs/FEDERATION.md).
    subset: bool = False


@dataclasses.dataclass(slots=True)
class PickResult:
    """reference handlers/server.go:72-77."""

    endpoint: str                       # primary "ip:port"
    fallbacks: list[str] = dataclasses.field(default_factory=list)
    mutated_body: Optional[bytes] = None
    extra_headers: dict[str, str] = dataclasses.field(default_factory=dict)
    # Assumed-load units this pick added (released on served feedback).
    assumed_cost: float = 1.0
    # Scheduler slot the assumed cost was CHARGED to (the primary pick).
    # Served feedback releases this slot, not the slot of whichever endpoint
    # the data plane failed over to — otherwise the primary's charge leaks
    # and the fallback gets a spurious release.
    charged_slot: Optional[int] = None
    # Disaggregated prefill/decode: every (slot, cost, hostport) the cycle
    # charged — both workers — released together on served feedback (the
    # hostport re-resolves to guard against slot reuse). When set it
    # supersedes charged_slot/assumed_cost for release bookkeeping.
    charged: Optional[list] = None
    # Optional (feature_row, picked_at) recorded for online latency training.
    feedback: Optional[tuple] = None
    # Flight-recorder decision record this pick published (gie_tpu/obs):
    # the serve-outcome path mutates its outcome fields in place so the
    # record closes with what the data plane actually did.
    record: Optional[dict] = None

    @property
    def destination_value(self) -> str:
        """Comma-separated ordered fallback list (004 README:50-82)."""
        if not self.fallbacks:
            return self.endpoint
        return ",".join([self.endpoint] + self.fallbacks)
