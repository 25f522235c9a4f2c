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
# collector and exposition are its own (runtime/metrics.py).
_FOREIGN = ("jax", "jaxlib", "flax", "gie_tpu", "prometheus_client")


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
                 "gie_tpu_torch.storm.__main__"):
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


@pytest.mark.parametrize("kwargs, slice_name", [
    ({"predictor_fn": lambda *a: None}, "latency-predictor"),
    ({"mesh": object()}, "multi-device"),
])
def test_out_of_slice_scheduler_arg_raises(kwargs, slice_name):
    with pytest.raises(NotImplementedError, match=slice_name):
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
# picker takes it: the resilience state and lattice warming are ported).
PICKER_ARGS = [
    ({"resilience": "ResilienceState"}, "resilience slice", None),
    ({"federation": object()}, "federation slice", NotImplementedError),
    ({"trainer": object()}, "latency-predictor slice", NotImplementedError),
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
        kwargs = {k: ResilienceState() if v == "ResilienceState" else v
                  for k, v in kwargs.items()}
        picker = BatchingTPUPicker(Scheduler(device="cpu"), Datastore(),
                                   MetricsStore(), **kwargs)
        assert all(getattr(picker, k) is v for k, v in kwargs.items())
        picker.close()
        return
    with pytest.raises(raises, match=slice_name):
        BatchingTPUPicker(Scheduler(device="cpu"), Datastore(),
                          MetricsStore(), **kwargs)
