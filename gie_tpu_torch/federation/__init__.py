"""Multi-cluster federation (port of gie_tpu/federation/).

One cluster is a hard capacity and availability ceiling. This package
removes it by making InferencePoolImport-backed peer pools first-class
schedulable capacity:

  summary.py   the bounded digest sections clusters exchange (era +
               drain meta, endpoint load summary, hot-prefix sample)
               over the CRC-guarded replication codec; frames equal the
               reference's byte for byte.
  exchange.py  the peer-to-peer transport: a long-poll publisher, and
               per-peer links with circuit breakers, jittered backoff,
               and the era-ordered split-brain convergence rule.
  state.py     imported endpoints in the live datastore slot space, the
               cross-cluster cost penalty (staleness-inflated, in
               queue-depth units through the metrics rows), the
               local-only blackout floor, the band-aware spill policy,
               and whole-cluster drain.

The batching picker calls ``FederationState.observe`` per wave and
``spill_candidates`` per item (sched/batching.py); the runner wires the
whole exchange behind ``--fed-*`` flags (runtime/runner.py). Imported
slots are scored by the same captured cycle and kernels as local ones.
"""

from gie_tpu_torch.federation.exchange import (
    FederationExchange,
    FederationHTTPServer,
    FederationPublisher,
    PeerLink,
)
from gie_tpu_torch.federation.state import FederationState

__all__ = [
    "FederationExchange",
    "FederationHTTPServer",
    "FederationPublisher",
    "FederationState",
    "PeerLink",
]
