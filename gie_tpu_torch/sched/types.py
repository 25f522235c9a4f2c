"""Scheduler state and batch types (port of gie_tpu/sched/types.py).

Frozen dataclasses of tensors take the place of the reference's
flax.struct pytrees. Every constructor names its device. u32 quantities
(chunk hashes, prefix keys, packed presence words, ages, rr, tick) are
int64 tensors holding values in [0, 2**32): torch's CPU uint32 lacks the
shifts, adds and max the reference's wraparound arithmetic needs, so each
op that can overflow is followed by `& U32_MASK`.

  EndpointBatch  — dense view of every endpoint's live metrics   [M, ...]
  RequestBatch   — dense view of N pending requests              [N, ...]
  SchedState     — cross-cycle scheduler state (assumed load, prefix
                   index, rr/tick counters, Sinkhorn duals), updated in
                   place by the cycle
  PickResult     — per-request ordered endpoint list + status
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from gie_tpu_torch.sched import constants as C


class _Replace:
    def replace(self, **changes):
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass(frozen=True)
class EndpointBatch(_Replace):
    """Dense endpoint-side inputs for one scheduling cycle. Row i is
    endpoint slot i; `valid` masks unused slots."""

    metrics: torch.Tensor       # f32[M, NUM_METRICS]
    valid: torch.Tensor         # bool[M]
    lora_active: torch.Tensor   # i32[M, LORA_SLOTS], adapter ids, -1 = empty
    lora_waiting: torch.Tensor  # i32[M, LORA_SLOTS]
    role: torch.Tensor          # i32[M], constants.Role

    @staticmethod
    def empty(m: int = C.M_MAX, *, device="cpu") -> "EndpointBatch":
        """`m` invalid slots, as the reference's EndpointBatch.empty."""
        return EndpointBatch(
            metrics=torch.zeros((m, C.NUM_METRICS), dtype=torch.float32,
                                device=device),
            valid=torch.zeros((m,), dtype=torch.bool, device=device),
            lora_active=torch.full((m, C.LORA_SLOTS), -1, dtype=torch.int32,
                                   device=device),
            lora_waiting=torch.full((m, C.LORA_SLOTS), -1, dtype=torch.int32,
                                    device=device),
            role=torch.zeros((m,), dtype=torch.int32, device=device),
        )


@dataclasses.dataclass(frozen=True)
class RequestBatch(_Replace):
    """Dense request-side inputs for one scheduling cycle. `subset_mask`
    is the strict candidate-subset hint (an all-False row yields 503)."""

    valid: torch.Tensor         # bool[N]
    lora_id: torch.Tensor       # i32[N], -1 = base model
    criticality: torch.Tensor   # i32[N], constants.Criticality
    prompt_len: torch.Tensor    # f32[N], prompt length (chars)
    decode_len: torch.Tensor    # f32[N], expected output length hint
    chunk_hashes: torch.Tensor  # int64[N, C] u32 rolling prefix-chunk hashes
    n_chunks: torch.Tensor      # i32[N] number of valid chunk hashes
    subset_mask: torch.Tensor   # bool[N, M]

    @staticmethod
    def empty(n: int, m: int = C.M_MAX, *, lanes: int = C.MAX_CHUNKS,
              device="cpu") -> "RequestBatch":
        """`n` invalid rows over `lanes` chunk lanes, as the reference's
        RequestBatch.empty; the field dtypes are the ones every
        constructor of a RequestBatch uses."""
        return RequestBatch(
            valid=torch.zeros((n,), dtype=torch.bool, device=device),
            lora_id=torch.full((n,), -1, dtype=torch.int32, device=device),
            criticality=torch.full((n,), int(C.Criticality.STANDARD),
                                   dtype=torch.int32, device=device),
            prompt_len=torch.zeros((n,), dtype=torch.float32, device=device),
            decode_len=torch.zeros((n,), dtype=torch.float32, device=device),
            chunk_hashes=torch.zeros((n, lanes), dtype=torch.int64,
                                     device=device),
            n_chunks=torch.zeros((n,), dtype=torch.int32, device=device),
            subset_mask=torch.ones((n, m), dtype=torch.bool, device=device),
        )


@dataclasses.dataclass(frozen=True)
class PrefixTable(_Replace):
    """Direct-mapped chunk-hash -> packed endpoint-set index: PREFIX_SLOTS
    rows of (u32 key, u32[m//32] presence words — bit m of word m//32 —,
    u32 age tick). Word values are bit-identical to the reference's."""

    keys: torch.Tensor     # int64[S] u32, 0 = empty
    present: torch.Tensor  # int64[S, m//32] u32 packed endpoint bits
    ages: torch.Tensor     # int64[S] u32 last-touch tick

    @staticmethod
    def empty(slots: int = C.PREFIX_SLOTS, m: int = C.M_MAX, *,
              device) -> "PrefixTable":
        return PrefixTable(
            keys=torch.zeros((slots,), dtype=torch.int64, device=device),
            present=torch.zeros((slots, m // 32), dtype=torch.int64,
                                device=device),
            ages=torch.zeros((slots,), dtype=torch.int64, device=device),
        )


@dataclasses.dataclass(frozen=True)
class SchedState(_Replace):
    """Cross-cycle scheduler state. The cycle updates these tensors in
    place (the role of the reference's donated buffers); readers that
    need a stable view take a copy (Scheduler.export_state)."""

    prefix: PrefixTable
    assumed_load: torch.Tensor  # f32[m] in normalized request-cost units
    rr: torch.Tensor            # int64 scalar, u32 round-robin counter
    tick: torch.Tensor          # int64 scalar, u32 cycle counter
    ot_v: torch.Tensor          # f32[m] Sinkhorn column duals (warm start)

    @staticmethod
    def init(slots: int = C.PREFIX_SLOTS, m: int = C.M_MAX, *,
             device) -> "SchedState":
        return SchedState(
            prefix=PrefixTable.empty(slots, m, device=device),
            assumed_load=torch.zeros((m,), dtype=torch.float32,
                                     device=device),
            rr=torch.zeros((), dtype=torch.int64, device=device),
            tick=torch.zeros((), dtype=torch.int64, device=device),
            ot_v=torch.ones((m,), dtype=torch.float32, device=device),
        )

    @property
    def m(self) -> int:
        """Endpoint-axis width this state is laid out for (an M bucket)."""
        return int(self.assumed_load.shape[0])


@dataclasses.dataclass(frozen=True)
class PickResult(_Replace):
    """Per-request outcome: `indices[n]` is primary + fallbacks (-1
    padded), `status` a constants.Status, `scores` the chosen lanes'
    scores, `affinity` the (prefix, session) columns at the primary pick
    when ProfileConfig.record_affinity is on. Under
    ProfileConfig.pd_disaggregation `indices` is the DECODE pick (the
    destination that owns the response stream) and `prefill` the prefill
    worker's slot (-1 on non-OK rows); `prefill` is None otherwise."""

    indices: torch.Tensor   # i32[N, FALLBACKS]
    status: torch.Tensor    # i32[N]
    scores: torch.Tensor    # f32[N, FALLBACKS]
    prefill: Optional[torch.Tensor] = None   # i32[N] | None
    affinity: Optional[torch.Tensor] = None  # f32[N, 2] | None


@dataclasses.dataclass(frozen=True)
class Weights(_Replace):
    """Scorer blend weights (float32 values held as Python floats)."""

    queue: float
    kv_cache: float
    prefix: float
    lora: float
    assumed_load: float
    latency: float
    session: float = 0.0

    @staticmethod
    def default() -> "Weights":
        return Weights(queue=1.0, kv_cache=1.0, prefix=2.0, lora=1.0,
                       assumed_load=1.0, latency=0.0, session=0.0)


def pad_requests(reqs: RequestBatch, n_bucket: int) -> RequestBatch:
    """Pad a RequestBatch up to `n_bucket` rows with zero (False) rows."""
    n = int(reqs.valid.shape[0])
    if n == n_bucket:
        return reqs
    if n > n_bucket:
        raise ValueError(f"batch of {n} does not fit bucket {n_bucket}")

    def _pad(x: torch.Tensor) -> torch.Tensor:
        out = x.new_zeros((n_bucket,) + tuple(x.shape[1:]))
        out[:n] = x
        return out

    return RequestBatch(**{
        f.name: _pad(getattr(reqs, f.name))
        for f in dataclasses.fields(RequestBatch)})


def bucket_for(n: int) -> int:
    for b in C.N_BUCKETS:
        if n <= b:
            return b
    raise ValueError(f"batch of {n} exceeds max bucket {C.N_BUCKETS[-1]}")


def chunk_bucket_for(count: int) -> int:
    """Smallest chunk-axis bucket covering `count` chunk lanes."""
    for b in C.C_BUCKETS:
        if count <= b:
            return b
    return C.MAX_CHUNKS


def m_bucket_for(count: int) -> int:
    """Smallest endpoint-axis bucket covering `count` slots (the high-water
    slot index + 1)."""
    for b in C.M_BUCKETS:
        if count <= b:
            return b
    raise ValueError(
        f"{count} endpoint slots exceed max bucket {C.M_BUCKETS[-1]}")


def resize_into(src: SchedState, dst: SchedState) -> SchedState:
    """Migrate scheduler state across an M-bucket boundary (the reference's
    resize_state) into `dst`, laid out for its own bucket, in place: slots
    past `src`'s width get zero load, cold duals (ones) and no presence
    bits; slots past `dst`'s width are dropped. Keys, ages and the counters
    carry over. Both tables have the same number of rows. -> dst, whose
    tensors keep their storage (a captured cycle holds their addresses)."""
    k = min(src.m, dst.m)
    w = k // 32
    dst.assumed_load[:k].copy_(src.assumed_load[:k])
    dst.assumed_load[k:].zero_()
    dst.ot_v[:k].copy_(src.ot_v[:k])
    dst.ot_v[k:].fill_(1.0)
    dst.prefix.present[:, :w].copy_(src.prefix.present[:, :w])
    dst.prefix.present[:, w:].zero_()
    dst.prefix.keys.copy_(src.prefix.keys)
    dst.prefix.ages.copy_(src.prefix.ages)
    dst.rr.copy_(src.rr)
    dst.tick.copy_(src.tick)
    return dst
