"""Vectorized filter stage (port of gie_tpu/sched/filters.py): every filter
is a boolean mask over the [N, M] request x endpoint grid, AND-ed
together; `drain_filter` is their host-side sibling over candidate lists."""

from __future__ import annotations

import torch

from gie_tpu_torch.sched import constants as C
from gie_tpu_torch.sched.types import EndpointBatch, RequestBatch


def drain_filter(candidates: list) -> list:
    """Graceful-drain candidate prefilter, on the host (docs/RESILIENCE.md):
    DRAINING endpoints (terminating pods completing their in-flight
    streams) leave a pick's candidate set before wave assembly, so the
    cycle sees them only through the subset mask.

    Availability beats drain: when every candidate is draining the set is
    returned unchanged, as it is when none is (callers compare `is`).
    """
    kept = [ep for ep in candidates if not getattr(ep, "draining", False)]
    if not kept or len(kept) == len(candidates):
        return candidates
    return kept


def base_mask(reqs: RequestBatch, eps: EndpointBatch) -> torch.Tensor:
    """Validity + strict subset-hint mask (an empty subset stays empty and
    surfaces as a 503, never as a fallback to the full pool)."""
    return reqs.valid[:, None] & eps.valid[None, :] & reqs.subset_mask


def saturation_mask(
    reqs: RequestBatch,
    eps: EndpointBatch,
    *,
    queue_limit: float,
    kv_limit: float,
) -> torch.Tensor:
    """Endpoints past the queue or KV limit are ineligible for
    STANDARD/SHEDDABLE requests; CRITICAL requests bypass the filter."""
    queue = eps.metrics[:, C.Metric.QUEUE_DEPTH]
    kv = eps.metrics[:, C.Metric.KV_CACHE_UTIL]
    has_capacity = (queue < queue_limit) & (kv < kv_limit)
    critical = reqs.criticality[:, None] == int(C.Criticality.CRITICAL)
    return critical | has_capacity[None, :]


def lora_membership(
    reqs: RequestBatch, eps: EndpointBatch
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(request, endpoint) adapter residency: (active[N,M],
    waiting[N,M]), shared by the LoRA filter and the LoRA scorer."""
    req_lora = reqs.lora_id[:, None, None]                     # [N, 1, 1]
    active = (req_lora == eps.lora_active[None, :, :]).any(dim=-1)
    waiting = (req_lora == eps.lora_waiting[None, :, :]).any(dim=-1)
    return active, waiting


def lora_capacity_mask(
    reqs: RequestBatch,
    eps: EndpointBatch,
    membership: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> torch.Tensor:
    """An endpoint is eligible for an adapter request if the adapter is
    active/waiting there or it still has a free adapter slot; base-model
    requests (-1) match everything."""
    active, waiting = (membership if membership is not None
                       else lora_membership(reqs, eps))
    resident = active | waiting                                # [N, M]

    n_active = (eps.lora_active >= 0).sum(dim=-1)              # [M]
    n_waiting = (eps.lora_waiting >= 0).sum(dim=-1)
    max_lora = eps.metrics[:, C.Metric.MAX_LORA]
    # max_lora == 0 means the server did not report LoRA metrics: no limit.
    has_slot = (max_lora <= 0) | ((n_active + n_waiting) < max_lora)

    is_base = reqs.lora_id[:, None] < 0
    return is_base | resident | has_slot[None, :]
