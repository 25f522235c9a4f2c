"""Multi-cluster inference environment: N member clusters + the data path
(copy of conformance/multicluster.py over gie_tpu_torch).

Implements the consumption side of proposal 1374 (reference
docs/proposals/1374-multi-cluster-inference/README.md:36-53) on top of the
in-process harness: a hub/spoke export controller (ClusterSet) mirrors
exported pools into same-name InferencePoolImports in every other member,
and requests on an importing cluster's route that reference an import are
carried to an exporting cluster in one of the two routing modes:

  Endpoint mode — importing IG -> exporting cluster's EPP -> the endpoint
      it selects (pod/service connectivity assumed between members).
  Parent mode — importing IG -> a parent Gateway of the exported pool in
      the exporting cluster -> that cluster's own route/EPP choreography
      (parent connectivity assumed between members).

Exporting-cluster selection is active-passive on basic EPP readiness
(1374 README 'InferencePool Selection'): prefer exporters whose EPP is
available with ready endpoints, in ClusterSet order.
"""

from __future__ import annotations

from gie_tpu_torch.conformance.harness import ConformanceEnv, Response
from gie_tpu_torch.api import types as api
from gie_tpu_torch.controller.multicluster import (
    ClusterSet,
    ROUTING_MODE_ENDPOINT,
    ROUTING_MODE_PARENT,
)

__all__ = [
    "MultiClusterInferenceEnv",
    "ROUTING_MODE_ENDPOINT",
    "ROUTING_MODE_PARENT",
]


class MultiClusterInferenceEnv:
    """A ClusterSet of ConformanceEnvs sharing one export controller."""

    def __init__(
        self,
        members: list[str],
        routing_mode: str = ROUTING_MODE_ENDPOINT,
        picker_mode: str = "rr",
        seed: int = 0,
        **env_kwargs,
    ):
        """`env_kwargs` go to every member's ConformanceEnv (the "tpu"
        EPPs' Scheduler arguments)."""
        if routing_mode not in (ROUTING_MODE_ENDPOINT, ROUTING_MODE_PARENT):
            raise ValueError(f"unknown routing mode {routing_mode!r}")
        self.routing_mode = routing_mode
        self.clusterset = ClusterSet(list(members))
        self.envs: dict[str, ConformanceEnv] = {
            m: ConformanceEnv(seed=seed, picker_mode=picker_mode, name=m,
                              **env_kwargs)
            for m in members
        }
        for env in self.envs.values():
            env.remote_router = self._route_imported

    def env(self, member: str) -> ConformanceEnv:
        return self.envs[member]

    def close(self) -> None:
        for env in self.envs.values():
            env.close()

    # ---- export controller (hub/spoke topology) --------------------------

    def apply_pool(self, cluster: str, pool: api.InferencePool) -> None:
        """Apply a pool in its home cluster AND run the export controller
        (1374 README 'Workflow' steps 1-2)."""
        self.envs[cluster].apply_pool(pool)
        self.clusterset.apply_pool(cluster, pool)
        self._sync_imports()

    def delete_pool(self, cluster: str, namespace: str, name: str) -> None:
        self.envs[cluster].delete_pool(namespace, name)
        self.clusterset.delete_pool(cluster, namespace, name)
        self._sync_imports()

    def _sync_imports(self) -> None:
        """Mirror the hub's import set into each member (same ns/name)."""
        for member, env in self.envs.items():
            env.set_imports({
                (ns, name): imp
                for (c, ns, name), imp in self.clusterset.imports.items()
                if c == member
            })

    # ---- cross-cluster data path -----------------------------------------

    # Cross-cluster hops are counted in a forwarded header so a cycle of
    # mutually-importing clusters (weighted rules splitting to each other's
    # imports) terminates with 508 instead of unbounded recursion.
    HOP_HEADER = "x-gie-multicluster-hops"
    MAX_HOPS = 4

    def _route_imported(self, importing_env, imp, host, path, headers,
                        body) -> Response:
        hops = int(headers.get(self.HOP_HEADER, "0"))
        if hops >= self.MAX_HOPS:
            return Response(508, {}, b"multi-cluster routing loop detected")
        headers = dict(headers, **{self.HOP_HEADER: str(hops + 1)})
        ns, name = imp.metadata.namespace, imp.metadata.name
        exported_by = {
            c.name
            for ctrl in imp.status.controllers
            for c in ctrl.exportingClusters
        }
        # Active-passive preference follows ClusterSet member order (the
        # operator's declared priority), not the alphabetical order the
        # status list is normalized to.
        exporting = [m for m in self.clusterset.members if m in exported_by]
        candidates = []
        for cname in exporting:
            env = self.envs.get(cname)
            if env is None:
                continue
            pool = env.get_pool(ns, name)
            epp = env.epps.get((ns, name))
            if pool is not None and epp is not None:
                candidates.append((env, pool, epp))
        if not candidates:
            return Response(503, {}, b"no exporting cluster available")
        # Active-passive: first exporter with an available EPP and ready
        # endpoints wins; fall back to any exporter (its own fail-open/
        # fail-close semantics then apply).
        ready = [
            c for c in candidates
            if c[2].available and c[2].datastore.endpoints()
        ]
        env, pool, epp = (ready or candidates)[0]

        if self.routing_mode == ROUTING_MODE_ENDPOINT:
            # Importing IG speaks ext-proc to the exported pool's EPP and
            # routes straight to the endpoint it picks.
            return env._forward(pool, epp, headers, body)

        # Parent mode: forward the whole request to a parent Gateway of the
        # exported pool; the remote cluster runs its own route matching and
        # EPP exchange.
        gw = self._parent_gateway_for(env, ns, name)
        if gw is None:
            return Response(503, {}, b"no remote parent gateway")
        return env.send(gw, host, path, headers=headers, body=body)

    @staticmethod
    def _parent_gateway_for(env: ConformanceEnv, namespace: str,
                            name: str):
        """A Gateway of the exporting cluster that routes to the pool."""
        for route in env.routes.values():
            if route.namespace != namespace:
                continue
            for rule in route.rules:
                for ref in rule.backend_refs:
                    if ref.kind == "InferencePool" and ref.name == name:
                        for gw in route.parent_gateways:
                            if gw in env.gateways:
                                return gw
        return None
