"""Vectorized score stage (port of gie_tpu/sched/scorers.py): each scorer
emits a full f32 column over the [N, M] grid (or an [M] row broadcast
later), blended by profile-level weights."""

from __future__ import annotations

import torch

from gie_tpu_torch.sched import constants as C
from gie_tpu_torch.sched.filters import lora_membership
from gie_tpu_torch.sched.types import EndpointBatch, RequestBatch


def queue_score(eps: EndpointBatch, *, queue_norm: float) -> torch.Tensor:
    """1 at empty queue, 0 at/after `queue_norm` outstanding -> f32[M]."""
    q = eps.metrics[:, C.Metric.QUEUE_DEPTH]
    return torch.clamp(1.0 - q / queue_norm, 0.0, 1.0)


def kv_cache_score(eps: EndpointBatch) -> torch.Tensor:
    """Least-KV-cache-utilization scorer -> f32[M]."""
    return torch.clamp(1.0 - eps.metrics[:, C.Metric.KV_CACHE_UTIL], 0.0, 1.0)


def lora_affinity_score(
    reqs: RequestBatch,
    eps: EndpointBatch,
    membership: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> torch.Tensor:
    """1.0 where the adapter runs, 0.75 where it waits to load, 0.25
    where it would need a fresh load, 1.0 for base-model requests
    -> f32[N, M]."""
    active, waiting = (membership if membership is not None
                       else lora_membership(reqs, eps))
    is_base = reqs.lora_id[:, None] < 0
    one = torch.ones((), dtype=torch.float32, device=active.device)
    tier = torch.where(
        active, one,
        torch.where(waiting, one * 0.75, one * 0.25))
    return torch.where(is_base, one, tier)


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2**32 for u32 values `a` held in int64 and a u32
    constant `c`, split at 16 bits so no partial product leaves int64's
    range (a full 32x32-bit product can exceed 2**63)."""
    lo = a * (c & 0xFFFF)
    hi = (a * (c >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & C.U32_MASK


def session_affinity_score(
    reqs: RequestBatch,
    eps: EndpointBatch,
    *,
    key_chunks: int = 1,
) -> torch.Tensor:
    """Consistent-hash session stickiness -> f32[N, M]: a rendezvous hash
    (splitmix32-style avalanche, u32 wraparound) of the chunk-hash chain
    at depth `key_chunks` over the valid endpoints. 1.0 for the winner,
    0.55 for the runner-up, 0.25 * a uniform fraction for the rest; 1.0
    everywhere for requests without a session key; 0 on invalid slots."""
    key, h = session_hash(reqs, eps, key_chunks=key_chunks)
    winner, h2 = runner_up_hash(h, h.amax(dim=-1, keepdim=True))
    return session_from_hash(reqs, eps, key, h, winner, h2,
                             h2.amax(dim=-1, keepdim=True))


def session_hash(reqs: RequestBatch, eps: EndpointBatch, *,
                 key_chunks: int = 1, col0: int = 0):
    """-> (the session key u32[N], the rendezvous hash u32[N, M] of each
    endpoint, 0 on invalid slots). `col0` is the global slot of eps' first
    lane (a tp shard's offset, parallel/mesh.py)."""
    depth = torch.clamp(
        torch.minimum(reqs.n_chunks, torch.full_like(reqs.n_chunks,
                                                     key_chunks)) - 1,
        0, reqs.chunk_hashes.shape[1] - 1,
    ).long()                                                 # [N]
    key = torch.gather(reqs.chunk_hashes, 1, depth[:, None])[:, 0]  # [N]

    m = eps.valid.shape[0]
    slots = torch.arange(col0, col0 + m, dtype=torch.int64, device=key.device)
    h = key[:, None] ^ _mul32(slots, 0x9E3779B1)[None, :]
    h = _mul32(h ^ (h >> 16), 0x7FEB352D)
    h = _mul32(h ^ (h >> 15), 0x846CA68B)
    h = h ^ (h >> 16)
    return key, torch.where(eps.valid[None, :], h, torch.zeros_like(h))


def runner_up_hash(h: torch.Tensor,
                   top: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (each row's winner lanes, where h is the row's max `top`; the
    hashes with the winners zeroed)."""
    winner = h == top
    return winner, torch.where(winner, torch.zeros_like(h), h)


def session_from_hash(reqs: RequestBatch, eps: EndpointBatch,
                      key: torch.Tensor, h: torch.Tensor,
                      winner: torch.Tensor, h2: torch.Tensor,
                      second: torch.Tensor) -> torch.Tensor:
    """The session score from session_hash's key and hashes, runner_up_hash
    of them against the row's max, and the row's runner-up hash `second`
    (the max of h2 over the whole row)."""
    frac = h.to(torch.float32) / float(2**32)                # [0, 1)
    runner = (h2 == second) & (h2 > 0)
    one = torch.ones((), dtype=torch.float32, device=key.device)
    score = torch.where(winner, one,
                        torch.where(runner, one * 0.55, 0.25 * frac))
    no_session = (reqs.n_chunks <= 0) | (key == 0)
    score = torch.where(no_session[:, None], one, score)
    return torch.where(eps.valid[None, :], score, torch.zeros_like(score))


def assumed_load_score(assumed_load: torch.Tensor, *,
                       load_norm: float) -> torch.Tensor:
    """1 at zero assumed load, decaying to 0 at `load_norm` cost units
    -> f32[M]."""
    return torch.clamp(1.0 - assumed_load / load_norm, 0.0, 1.0)
