"""(Copy of gie_tpu/resilience/deadline.py, imports rewritten to gie_tpu_torch.)

Request-deadline propagation: Envoy header -> admission -> pick.

Envoy already knows every request's budget: the route timeout rides in
``x-envoy-expected-rq-timeout-ms``, and callers can pin a tighter bound
with ``x-gateway-request-deadline-ms`` (ours wins when both appear). A
request whose budget is exhausted — it queued behind a jit compile, a
degraded pick, a flow-control hold — must shed with 503 *before* the
scheduler charges a TPU cycle for an answer nobody is waiting for.

The deadline is carried as a monotonic timestamp (``0.0`` = none) on the
RequestContext and PickRequest, checked at the two points where waiting
happens: admission entry (the pick may be about to block) and the
batching collector's wave assembly (the item may have queued past its
budget). Zero configured deadline costs two dict lookups per request —
the fast-lane histogram guards that.
"""

from __future__ import annotations

from typing import Optional

from gie_tpu_torch.runtime.clock import MONOTONIC

# Caller-pinned deadline (takes precedence) and Envoy's route timeout.
GATEWAY_DEADLINE_HEADER = "x-gateway-request-deadline-ms"
ENVOY_TIMEOUT_HEADER = "x-envoy-expected-rq-timeout-ms"
DEADLINE_HEADERS = (GATEWAY_DEADLINE_HEADER, ENVOY_TIMEOUT_HEADER)

# Reported back to the client on the headers response so downstream hops
# can inherit the remaining budget.
REMAINING_HEADER = "x-gateway-deadline-remaining-ms"

# Budgets below this are treated as absent: a sub-millisecond deadline
# cannot survive even the batching window and would turn the header into
# a 503 generator.
_MIN_BUDGET_S = 0.001
# And budgets beyond this are clamped (a hostile 1e308 ms header must
# not produce an inf deadline that poisons arithmetic downstream).
_MAX_BUDGET_S = 3600.0


class DeadlineExceeded(Exception):
    """Budget exhausted -> ImmediateResponse 503 (the endpoint-picker
    protocol's unavailable semantics; distinct from ShedError's 429 —
    the client's own clock gave up, not our load shedding)."""

    def __init__(self, stage: str = "admission"):
        super().__init__(f"request deadline exceeded at {stage}")
        self.stage = stage


def _budget_from(values: Optional[list]) -> Optional[float]:
    if not values:
        return None
    try:
        ms = float(values[0])
    except (TypeError, ValueError):
        return None
    if not (ms == ms) or ms <= 0:  # NaN or non-positive
        return None
    return min(ms / 1000.0, _MAX_BUDGET_S)


def deadline_from_headers(
    headers: dict, now: Optional[float] = None
) -> float:
    """Monotonic deadline for this request, or 0.0 when no (usable)
    deadline header is present."""
    budget = _budget_from(headers.get(GATEWAY_DEADLINE_HEADER))
    if budget is None:
        budget = _budget_from(headers.get(ENVOY_TIMEOUT_HEADER))
    if budget is None or budget < _MIN_BUDGET_S:
        return 0.0
    return (MONOTONIC.now() if now is None else now) + budget


def remaining_s(deadline_at: float, now: Optional[float] = None) -> float:
    """Seconds of budget left; +inf when no deadline is set."""
    if deadline_at <= 0.0:
        return float("inf")
    now = MONOTONIC.now() if now is None else now
    return deadline_at - now


def expired(deadline_at: float, now: Optional[float] = None) -> bool:
    if deadline_at <= 0.0:
        return False
    return (MONOTONIC.now() if now is None else now) >= deadline_at
