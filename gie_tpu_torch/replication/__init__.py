"""HA state replication: warm-standby EPP followers via anti-entropy sync
(port of gie_tpu/replication/).

A leader publishes its soft state — the prefix-cache table, the assumed
load, the Sinkhorn warm-start duals and the autoscale capacity EWMA — as
a CRC-guarded digest over HTTP; followers poll it, validate it, and
install it into the live scheduler, so winning an election later needs
no restore step. The digest's bytes equal the reference's for the same
arrays, so a port follower syncs from a reference leader and back.

  codec.py      versioned, chunked, CRC-guarded digest wire format
  publisher.py  leader-side: epoch-versioned digest snapshots over HTTP
                (ETag = state epoch; delta frames since a known epoch)
  follower.py   non-leader loop: discover the leader from the lease holder
                identity, poll with jittered backoff, validate, install
  manager.py    role-transition wiring: promote warm on election win,
                flip back to syncing on demotion
"""

from gie_tpu_torch.replication.codec import (
    Digest,
    decode_digest,
    encode_digest,
    encode_section,
)
from gie_tpu_torch.replication.follower import FollowerSync
from gie_tpu_torch.replication.manager import (
    ReplicationManager,
    advertise_from_identity,
    replication_identity,
)
from gie_tpu_torch.replication.publisher import (
    ReplicationHTTPServer,
    StatePublisher,
)

__all__ = [
    "Digest",
    "decode_digest",
    "encode_digest",
    "encode_section",
    "FollowerSync",
    "ReplicationManager",
    "ReplicationHTTPServer",
    "StatePublisher",
    "advertise_from_identity",
    "replication_identity",
]
