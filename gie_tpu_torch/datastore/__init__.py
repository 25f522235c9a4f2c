"""Data layer: pool + endpoint cache with dense TPU slot allocation."""

from gie_tpu_torch.datastore.objects import Endpoint, EndpointPool, Pod
from gie_tpu_torch.datastore.datastore import Datastore, PoolNotSyncedError

__all__ = ["Datastore", "Endpoint", "EndpointPool", "Pod", "PoolNotSyncedError"]
