"""gie_tpu_torch stands alone: no JAX, no gie_tpu, its own constants, and
configurations outside the ported slice refused at construction."""

import ast
import dataclasses
import json
import pathlib
import subprocess
import sys

import pytest
import torch

import gie_tpu.sched.constants as JC
import gie_tpu_torch.sched.constants as TC
from gie_tpu_torch.sched import ProfileConfig, Scheduler

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "gie_tpu_torch"

_PROBE = """
import importlib, json, pkgutil, sys
import gie_tpu_torch
for mod in pkgutil.walk_packages(gie_tpu_torch.__path__, "gie_tpu_torch."):
    importlib.import_module(mod.name)
from gie_tpu_torch.ops import build
assert build._lib is None, "importing the package built the kernels"
print(json.dumps(sorted(sys.modules)))
"""


# Never imported by the port, the ext-proc transport included: its
# collector and exposition are its own (runtime/metrics.py), and its
# conformance harness is gie_tpu_torch/conformance, never the top-level
# conformance package (which imports gie_tpu).
_FOREIGN = ("jax", "jaxlib", "flax", "gie_tpu", "prometheus_client",
            "conformance")


def test_import_pulls_in_no_jax_and_no_gie_tpu():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, capture_output=True,
        text=True, timeout=120, check=True)
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    for name in ("gie_tpu_torch.sched.profile", "gie_tpu_torch.runtime.main",
                 "gie_tpu_torch.runtime.runner", "gie_tpu_torch.extproc.service",
                 "gie_tpu_torch.metricsio.engine", "gie_tpu_torch.obs.debugz",
                 "gie_tpu_torch.resilience.breaker",
                 "gie_tpu_torch.resilience.ladder",
                 "gie_tpu_torch.resilience.outlier",
                 "gie_tpu_torch.resilience.scenarios",
                 "gie_tpu_torch.obs.recorder", "gie_tpu_torch.obs.otlp",
                 "gie_tpu_torch.obs.metricscheck",
                 "gie_tpu_torch.obs.__main__",
                 "gie_tpu_torch.storm.engine", "gie_tpu_torch.storm.search",
                 "gie_tpu_torch.storm.__main__",
                 "gie_tpu_torch.fleet.picker",
                 "gie_tpu_torch.models.latency",
                 "gie_tpu_torch.simulator.cluster",
                 "gie_tpu_torch.controller.kube",
                 "gie_tpu_torch.controller.status",
                 "gie_tpu_torch.api.cel", "gie_tpu_torch.api.crdgen",
                 "gie_tpu_torch.bbr.chain",
                 "gie_tpu_torch.conformance.harness",
                 "gie_tpu_torch.conformance.multicluster",
                 "gie_tpu_torch.lint", "gie_tpu_torch.lint.runner",
                 "gie_tpu_torch.lint.tracesafe", "gie_tpu_torch.lint.dynamic",
                 "gie_tpu_torch.lint.__main__",
                 "gie_tpu_torch.utils.costmodel"):
        assert name in loaded
    forbidden = [
        name for name in loaded
        if name in _FOREIGN or name.startswith(tuple(f + "." for f in _FOREIGN))
    ]
    assert forbidden == []


def _imported_modules(path: pathlib.Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    return names


def test_source_scan_finds_no_jax_or_gie_tpu_import():
    files = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) >= 15
    # Every subpackage is in the scan, the fleet picker's, the latency
    # predictor's, the simulator's, the kube slice's, the lint's and the
    # cost model's included. (The lint's rule tables name gie_tpu. and
    # jax. in strings; only imports count.)
    assert {f.parent.name for f in files} >= {"fleet", "federation",
                                              "sched", "storm", "models",
                                              "simulator", "api", "bbr",
                                              "controller", "conformance",
                                              "lint", "utils"}
    assert {PKG / "models" / "latency.py",
            PKG / "simulator" / "cluster.py",
            PKG / "lint" / "tracesafe.py",
            PKG / "utils" / "costmodel.py"} <= set(files)
    bad = [
        (str(f.relative_to(REPO)), name)
        for f in files for name in _imported_modules(f)
        if name.split(".")[0] in _FOREIGN
    ]
    assert bad == []


@pytest.mark.parametrize("name", [
    "M_MAX", "M_WORDS", "M_BUCKETS", "N_BUCKETS", "CHARS_PER_TOKEN",
    "MAX_CHUNKS", "C_BUCKETS", "CHUNK_BYTES", "LORA_SLOTS", "FALLBACKS",
    "NEG_SCORE", "PREFIX_SLOTS", "NUM_METRICS",
])
def test_constant_equals_reference(name):
    assert getattr(TC, name) == getattr(JC, name)


@pytest.mark.parametrize("enum_name",
                         ["Metric", "Status", "Criticality", "Role"])
def test_enum_equals_reference(enum_name):
    ref = {e.name: int(e) for e in getattr(JC, enum_name)}
    port = {e.name: int(e) for e in getattr(TC, enum_name)}
    assert port == ref


def test_profile_config_fields_match_reference():
    from gie_tpu.sched.profile import ProfileConfig as JaxProfileConfig

    ref = {f.name: f.default for f in dataclasses.fields(JaxProfileConfig)}
    port = {f.name: f.default for f in dataclasses.fields(ProfileConfig)}
    assert port == ref


def test_scheduler_without_device_raises_when_cuda_is_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Scheduler()
    assert Scheduler(device="cpu").device == torch.device("cpu")


@pytest.mark.parametrize("kwargs", [
    {"scorer": "learned"},
    {"picker": "random"},
    {"picker": "random", "pd_disaggregation": True},
])
def test_formerly_refused_config_builds(kwargs):
    """The learned scorer and the random picker are ported: a profile
    that asks for them builds a Scheduler, and the reference agrees."""
    from gie_tpu.sched.profile import ProfileConfig as JaxProfileConfig

    assert Scheduler(ProfileConfig(**kwargs), device="cpu").cfg == (
        ProfileConfig(**kwargs))
    JaxProfileConfig(**kwargs)


# (Scheduler keyword, the slice that brought it, the error it raises or
# None where the Scheduler takes it: the latency predictor and the mesh
# are ported, and nothing is refused any more).
SCHEDULER_ARGS = [
    ({"predictor_fn": "predictor_score_fn"}, "latency-predictor", None),
    ({"mesh": "make_mesh"}, "multi-device", None),
]


@pytest.mark.parametrize(
    "kwargs, slice_name, raises", SCHEDULER_ARGS,
    ids=[f"kwargs{i}-{name}" for i, (_, name, _) in enumerate(SCHEDULER_ARGS)])
def test_out_of_slice_scheduler_arg_raises(kwargs, slice_name, raises):
    from gie_tpu_torch.sched import profile

    assert not hasattr(profile, "_LATER")
    assert not hasattr(profile, "_not_ported")
    if "mesh" in kwargs:
        from gie_tpu_torch.parallel import ShardedState, make_mesh

        sched = Scheduler(mesh=make_mesh(8, device="cpu"))
        assert sched.mesh.shape == {"dp": 4, "tp": 2}
        assert sched._min_bucket == 4 and sched.device.type == "cpu"
        assert isinstance(sched.state, ShardedState)
        return
    if raises is None:
        from gie_tpu_torch.models.latency import (
            LatencyPredictor,
            predictor_score_fn,
        )

        predictor = LatencyPredictor()
        fn = predictor_score_fn(predictor)
        sched = Scheduler(device="cpu", predictor_fn=fn,
                          predictor_params=predictor.init())
        assert sched.predictor_fn is fn
        assert sched._graph_schema()[-1] == "latency"
        return
    with pytest.raises(raises, match=slice_name):
        Scheduler(device="cpu", **kwargs)


def test_reference_validation_still_applies():
    with pytest.raises(ValueError, match="sinkhorn_rounding_temp"):
        ProfileConfig(sinkhorn_rounding_temp=0.0)
    with pytest.raises(ValueError, match="use_pallas_topk"):
        ProfileConfig(scorer="learned", use_pallas_topk=True)


# The pick service (the batching picker and every module it or its
# datastore and metrics store import) must run where only PyTorch is
# installed: the card's machine has no grpcio, protobuf or
# prometheus_client.
_SLICE_PROBE = """
import json, sys
import gie_tpu_torch.sched.batching, gie_tpu_torch.datastore
import gie_tpu_torch.metricsio, gie_tpu_torch.obs.trace
import gie_tpu_torch.utils.podutil
print(json.dumps(sorted(sys.modules)))
"""
_HOST_ONLY = ("jax", "jaxlib", "flax", "gie_tpu", "grpc", "google.protobuf",
              "prometheus_client")


def test_pick_service_pulls_in_no_grpc_protobuf_or_prometheus():
    out = subprocess.run(
        [sys.executable, "-c", _SLICE_PROBE], cwd=REPO, capture_output=True,
        text=True, timeout=120, check=True)
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    slice_modules = [n for n in loaded if n.startswith("gie_tpu_torch.")]
    for name in ("gie_tpu_torch.datastore.datastore",
                 "gie_tpu_torch.metricsio.store",
                 "gie_tpu_torch.extproc.pick",
                 "gie_tpu_torch.fairness.budgets",
                 "gie_tpu_torch.runtime.metrics",
                 "gie_tpu_torch.runtime.clock",
                 "gie_tpu_torch.resilience.ladder",
                 "gie_tpu_torch.resilience.breaker"):
        assert name in slice_modules
    forbidden = [n for n in loaded
                 if n in _HOST_ONLY or n.startswith(
                     tuple(m + "." for m in _HOST_ONLY))]
    assert forbidden == []
    # And no source file of those modules names them, even lazily.
    bad = []
    for name in slice_modules:
        path = REPO / (name.replace(".", "/") + ".py")
        if not path.exists():
            path = path.with_suffix("") / "__init__.py"
        bad += [(name, imp) for imp in _imported_modules(path)
                if imp in _HOST_ONLY or imp.startswith(
                    tuple(m + "." for m in _HOST_ONLY))]
    assert bad == []


# (picker keyword, the slice it is refused until, or None where the
# picker takes it: the resilience state, federation, lattice warming and
# the latency predictor's trainer are ported).
PICKER_ARGS = [
    ({"resilience": "ResilienceState"}, "resilience slice", None),
    ({"federation": "FederationState"}, "federation slice", None),
    ({"trainer": "OnlineTrainer"}, "latency-predictor slice", None),
    ({"background_warm": True}, "warm-lattice slice", None),
]


@pytest.mark.parametrize(
    "kwargs, slice_name, raises", PICKER_ARGS,
    ids=[f"kwargs{i}-{name}" for i, (_, name, _) in enumerate(PICKER_ARGS)])
def test_out_of_slice_picker_arg_raises(kwargs, slice_name, raises):
    from gie_tpu_torch.datastore import Datastore
    from gie_tpu_torch.metricsio import MetricsStore
    from gie_tpu_torch.resilience import ResilienceState
    from gie_tpu_torch.sched.batching import BatchingTPUPicker

    if raises is None:
        from gie_tpu_torch.federation import FederationState
        from gie_tpu_torch.models.latency import (
            LatencyPredictor,
            OnlineTrainer,
        )

        sched, ds, ms = Scheduler(device="cpu"), Datastore(), MetricsStore()
        made = {"ResilienceState": lambda: ResilienceState(),
                "FederationState": lambda: FederationState(
                    ds, ms, scheduler=sched, cluster="east"),
                "OnlineTrainer": lambda: OnlineTrainer(
                    LatencyPredictor(), device="cpu")}
        kwargs = {k: made[v]() if v in made else v
                  for k, v in kwargs.items()}
        picker = BatchingTPUPicker(sched, ds, ms, **kwargs)
        assert all(getattr(picker, k) is v for k, v in kwargs.items())
        picker.close()
        return
    with pytest.raises(raises, match=slice_name):
        BatchingTPUPicker(Scheduler(device="cpu"), Datastore(),
                          MetricsStore(), **kwargs)


# (argv of the port's runner, the slice that brought it, the error it
# raises or None where the runner builds: the kube slice's Lease elector
# and applying actuator are ported, and so is --mesh-devices, which with
# an injected scheduler builds no mesh, as in the reference).
RUNNER_ARGS = [
    (["--autoscale-mode", "apply"], "kube", None),
    (["--leader-elect"], "kube", None),
    (["--mesh-devices", "2"], "multi-device", None),
]


@pytest.mark.parametrize(
    "argv, slice_name, raises", RUNNER_ARGS,
    ids=[" ".join(a) for a, _, _ in RUNNER_ARGS])
def test_out_of_slice_runner_option_raises(argv, slice_name, raises):
    import argparse

    from gie_tpu_torch.controller import FakeCluster
    from gie_tpu_torch.runtime.options import Options
    from gie_tpu_torch.runtime.runner import ExtProcServerRunner

    class KubeCluster(FakeCluster):
        """A cluster client with the kube adapter's HTTP core."""

        def _json(self, method, path, body=None, content_type=None):
            raise AssertionError("construction calls no apiserver")

    parser = argparse.ArgumentParser()
    Options.add_flags(parser)
    opts = Options.from_args(parser.parse_args(
        ["--pool-name", "p", "--no-resilience", "--no-obs"] + argv))
    if raises is not None:
        with pytest.raises(raises, match=slice_name):
            ExtProcServerRunner(opts, KubeCluster(),
                                scheduler=Scheduler(device="cpu"))
        return
    sched = Scheduler(device="cpu")
    runner = ExtProcServerRunner(opts, KubeCluster(), scheduler=sched)
    try:
        assert runner.scheduler is sched and sched.mesh is None
        assert (runner.elector is not None) == opts.leader_elect
        assert (runner.autoscaler is not None) == (
            opts.autoscale_mode == "apply")
    finally:
        runner.stop()


def test_conformance_harness_stands_alone():
    """The port's harness imports nothing of the top-level conformance
    package, and its meshed mode serves a Scheduler over every virtual
    CPU position (dp 8, tp 1), as the reference's serves one over every
    device."""
    files = sorted((PKG / "conformance").glob("*.py"))
    assert {f.name for f in files} >= {"__init__.py", "harness.py",
                                       "multicluster.py", "report.py"}
    for f in files:
        assert not [n for n in _imported_modules(f)
                    if n.split(".")[0] in _FOREIGN], f
    from gie_tpu_torch.conformance import ConformanceEnv
    from gie_tpu_torch.datastore import Pod

    env = ConformanceEnv(picker_mode="tpu-mesh", device="cpu")
    env.cluster.apply_pod(Pod(name="p", labels={"app": "a"}, ip="10.1.0.1"))
    from gie_tpu_torch.api import types as api

    try:
        env.apply_pool(api.InferencePool(
            metadata=api.ObjectMeta(name="pool"),
            spec=api.InferencePoolSpec(
                selector=api.LabelSelector(matchLabels={"app": "a"}),
                targetPorts=[api.Port(8000)])))
        (epp,) = env.epps.values()
        sched = epp.server.picker.scheduler
        assert sched.mesh.shape == {"dp": 8, "tp": 1}
        assert sched._min_bucket == 8
    finally:
        env.close()
