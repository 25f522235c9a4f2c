"""Typed API clients (the clientset analogue, reference C3 client-go/)
(copy of gie_tpu/api/client.py).

The reference generates a full clientset/informers/listers tree; the
Python-native equivalent is a thin typed facade over any object store that
speaks the ClusterClient/FakeCluster surface: get/list/apply/delete plus
status updates, returning the typed objects of gie_tpu_torch.api.types.
"""

from __future__ import annotations

from typing import Optional

from gie_tpu_torch.api import types as api


class InferencePoolClient:
    """Typed access to InferencePool objects (clientset.InferencePools())."""

    def __init__(self, store):
        # `store` is any object store with get_pool (reads) and, for write
        # support, apply_pool/delete_pool (FakeCluster has all three; the
        # kube adapter supports status writes via patch_pool_status but not
        # spec writes, so spec writes raise a clear NotImplementedError
        # instead of an AttributeError).
        self._store = store

    def _write(self, method: str, *args) -> None:
        fn = getattr(self._store, method, None)
        if fn is None:
            raise NotImplementedError(
                f"store {type(self._store).__name__} is read-only "
                f"(no {method}); apply changes through kubectl / the "
                "CustomObjects API in real clusters"
            )
        fn(*args)

    def get(self, name: str, namespace: str = "default") -> Optional[api.InferencePool]:
        return self._store.get_pool(namespace, name)

    def apply(self, pool: api.InferencePool) -> api.InferencePool:
        pool.validate()
        self._write("apply_pool", pool)
        return pool

    def delete(self, name: str, namespace: str = "default") -> None:
        self._write("delete_pool", namespace, name)

    def update_status(
        self, pool: api.InferencePool, status: api.InferencePoolStatus
    ) -> api.InferencePool:
        """Status-subresource style update: validates the 32-parent bound
        and commits BEFORE mutating the caller's object, so a store-side
        rejection never leaves the local object diverged from the store."""
        status.validate()
        # Stores with a dedicated status subresource (the kube adapter's
        # patch_pool_status) take the narrow write; object stores without
        # one (FakeCluster) re-apply the whole object.
        if hasattr(self._store, "patch_pool_status"):
            self._store.patch_pool_status(
                pool.metadata.namespace, pool.metadata.name, status)
            pool.status = status
            return pool
        import copy

        committed = copy.deepcopy(pool)
        committed.status = status
        self._write("apply_pool", committed)
        pool.status = status
        return pool

    def server_side_apply(self, cfg) -> api.InferencePool:
        """Server-side apply of an InferencePoolApply configuration
        (gie_tpu_torch.api.applyconfiguration): merge the sparse patch onto the
        stored object — absent fields keep their stored values — validate,
        and commit. The client-go clientset.Apply(...) analogue."""
        from gie_tpu_torch.api.applyconfiguration import apply_pool_configuration

        existing = self._store.get_pool(cfg.namespace, cfg.name)
        merged = apply_pool_configuration(existing, cfg)
        self._write("apply_pool", merged)
        return merged

    def to_yaml(self, pool: api.InferencePool) -> str:
        import yaml

        return yaml.safe_dump(api.pool_to_dict(pool), sort_keys=False)

    def from_yaml(self, text: str) -> api.InferencePool:
        import yaml

        pool = api.pool_from_dict(yaml.safe_load(text))
        pool.validate()
        return pool
