"""gie-lint for the port, against gie_tpu's.

The carried rules (GL001-GL004, GR001, GA001, GC001) give the reference's
violations on every reference fixture and on the gie_tpu/ tree; the
torch rules (GT001-GT004 with their CUDA-graph meanings, and the torch
[d2h] entries of GL002) fire on inline golden violations and stay silent
on their negatives; gie_tpu_torch/ is clean modulo its baseline, with
every lock ranked, no rank stale and the capture roots reaching the
kernels; the baseline machinery and the CLI keep their contract.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
import textwrap

import pytest

from gie_tpu.lint.runner import run_paths as ref_run_paths
from gie_tpu_torch.lint import baseline, tomlmini, tracesafe
from gie_tpu_torch.lint.model import RepoIndex, Violation
from gie_tpu_torch.lint.runner import (
    DEFAULT_BASELINE, DEFAULT_CONFIG, run_paths)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures", "lint")
FIXTURE_CONFIG = os.path.join(FIXTURES, "lockorder.toml")
REF_CONFIG = os.path.join(REPO, "gie_tpu", "lint", "lockorder.toml")
STEMS = sorted(f[:-3] for f in os.listdir(FIXTURES) if f.endswith(".py"))
CARRIED = ("GL", "GR", "GA", "GC")


def _rendered(violations, port: bool) -> list[str]:
    out = [v.render() for v in violations]
    if port:
        # The one named difference of the carried rules' text: GC001 names
        # the port's own Clock seam module.
        out = [r.replace("gie_tpu_torch/runtime/clock.py",
                         "gie_tpu/runtime/clock.py") for r in out]
    return out


# --------------------------------------------------------------------------
# Carried rules: the reference's violations, fixture by fixture
# --------------------------------------------------------------------------


@pytest.mark.parametrize("family", CARRIED)
@pytest.mark.parametrize("stem", STEMS)
def test_carried_rules_equal_the_reference_on_its_fixtures(stem, family):
    path = os.path.join(FIXTURES, f"{stem}.py")
    kw = dict(config=FIXTURE_CONFIG, baseline_path="", rules={family})
    want, want_stale = ref_run_paths([path], **kw)
    got, got_stale = run_paths([path], **kw)
    assert _rendered(got, True) == _rendered(want, False)
    assert got_stale == want_stale == []


@pytest.mark.parametrize("family", CARRIED)
def test_carried_fixtures_are_not_vacuous(family):
    """Each family's golden fixture fires in the port: the parity above
    compares findings, not two empty lists."""
    bad = [s for s in STEMS if s.startswith(family.lower())
           and s.endswith(("_bad", "_stale"))]
    assert bad
    for stem in bad:
        got, _ = run_paths([os.path.join(FIXTURES, f"{stem}.py")],
                           config=FIXTURE_CONFIG, baseline_path="",
                           rules={family})
        assert got, f"{family} found nothing in {stem}.py"


def _reversed_ranks(tmp_path) -> str:
    text = open(REF_CONFIG).read()
    text = re.sub(r'^("[^"]+") = (\d+)$',
                  lambda m: f"{m.group(1)} = {100 - int(m.group(2))}",
                  text, flags=re.M)
    p = tmp_path / "reversed.toml"
    p.write_text(text)
    return str(p)


def _no_ranks(tmp_path) -> str:
    text = open(REF_CONFIG).read()
    text = re.sub(r'^"[^"]+" = \d+$', "", text, flags=re.M)
    p = tmp_path / "unranked.toml"
    p.write_text(text)
    return str(p)


@pytest.mark.parametrize("variant,expect", [
    ("declared", 0),         # the reference tree is clean under its ranks
    ("reversed", 4),         # every statically seen nesting inverts
    ("unranked", 35),        # GL003 for each of its 35 locks
])
def test_carried_rules_equal_the_reference_on_its_tree(variant, expect,
                                                        tmp_path):
    config = {"declared": lambda: REF_CONFIG,
              "reversed": lambda: _reversed_ranks(tmp_path),
              "unranked": lambda: _no_ranks(tmp_path)}[variant]()
    kw = dict(config=config, baseline_path="", rules=set(CARRIED))
    root = os.path.join(REPO, "gie_tpu")
    want, _ = ref_run_paths([root], **kw)
    got, _ = run_paths([root], **kw)
    assert _rendered(got, True) == _rendered(want, False)
    assert len(got) == expect


def test_reference_tree_locks_indexed_alike():
    from gie_tpu.lint.model import RepoIndex as RefIndex

    root = os.path.join(REPO, "gie_tpu")
    ours = RepoIndex.build(root, package_prefix="gie_tpu.")
    theirs = RefIndex.build(root, package_prefix="gie_tpu.")
    assert {n: (d.kind, d.file, d.line) for n, d in ours.locks.items()} == {
        n: (d.kind, d.file, d.line) for n, d in theirs.locks.items()}
    assert len(ours.locks) == 35


# --------------------------------------------------------------------------
# Torch rules: inline golden violations and negatives
# --------------------------------------------------------------------------

TORCH_CONFIG = """
[ranks]
"gl002_torch_bad.Sched._lock" = 10
"gl002_torch_ok.Sched._lock" = 10

[blocking]
calls = ["time.sleep"]

[d2h]
calls = [
    "torch.cuda.synchronize",
    "torch.cuda.Event.synchronize",
    "torch.cuda.Stream.synchronize",
    "torch.Tensor.cpu",
    "torch.Tensor.item",
    "torch.Tensor.tolist",
]
methods = []

[tracesafe]
capture_roots = [
    "gt002_torch_bad.Engine._cycle",
    "gt002_torch_ok.Engine._cycle",
]
build_modules = ["gie_tpu_torch.ops.build"]
parallel_modules = ["gt004_torch_bad", "gt004_torch_ok"]

[tracesafe.capture_stops]
"gt002_torch_bad.py:_load_once" = "runs once before any capture"

[tracesafe.allow_functions]
"gt003_torch_bad.py:Wave._wait" = "the materialize contract"
"gt003_torch_ok.py:Wave._wait" = "the materialize contract"
"""

SOURCES = {
    "gt001_torch_bad": '''
        import torch
        from gie_tpu_torch.ops import build

        _ON_CARD = torch.zeros(4, device="cuda")
        _MOVED = torch.ones(2).cuda()
        _TO = torch.arange(3).to(torch.device("cuda", 0))
        _DEV = torch.cuda.current_device()
        _STREAM = torch.cuda.Stream()
        build.library()


        class Holder:
            EVENT = torch.cuda.Event()


        def pick(x, buf=torch.empty(3, device=torch.device("cuda"))):
            return x
    ''',
    "gt001_torch_ok": '''
        import torch

        _CPU = torch.zeros(4)
        _DEV = torch.device("cuda")
        _AVAILABLE = torch.cuda.is_available


        def lazy(dev="cuda"):
            from gie_tpu_torch.ops import build

            build.library()
            return torch.zeros(4, device=dev).cuda()
    ''',
    "gt002_torch_bad": '''
        import time

        import numpy as np
        import torch


        def _leaf(x):
            print("captured")
            return float(x.sum())


        def _load_once():
            return time.monotonic()


        def _stage(x, k: int, scale=2.0):
            n = x.shape[0]
            y = x * float(n) * float(k) * float(scale)
            idx = torch.nonzero(x)
            z = x[torch.where(x > 0)]
            u = torch.unique(x)
            m = x.masked_select(x > 0)
            return (_leaf(y) + x.item() + len(x.tolist()) + x.cpu().sum()
                    + x.numpy().sum() + idx + z + u + m)


        class Engine:
            def _cycle(self, x):
                t0 = time.perf_counter()
                torch.cuda.synchronize()
                a = np.asarray(x)
                _load_once()
                return _stage(x, 3) + t0 + a

            def off_path(self, x):
                print(x.item())
    ''',
    "gt002_torch_ok": '''
        import torch

        from gie_tpu_torch.sched import constants as C

        EPS = 1e-6


        def _stage(x, k: int, temperature: float = 0.5):
            rows, cols = x.shape
            planes = [x, x]
            acc = sum(p * float(1 << j) for j, p in enumerate(planes))
            ok = x == int(C.Status.OK)
            return torch.where(ok, acc * float(temperature),
                               torch.clamp(x, min=float(EPS))) * float(rows)


        class Engine:
            def _cycle(self, x):
                return _stage(x, 3) + torch.topk(x, 2).values.sum()
    ''',
    "gt003_torch_bad": '''
        import torch


        class Wave:
            def __init__(self):
                self.event = torch.cuda.Event()

            def _wait(self):
                self.event.synchronize()

            def peek(self):
                self.event.synchronize()


        def drain():
            torch.cuda.synchronize()


        def stream_wait(s: torch.cuda.Stream):
            s.synchronize()
    ''',
    "gt003_torch_ok": '''
        import torch


        class Wave:
            def __init__(self):
                self.event = torch.cuda.Event()

            def _wait(self):
                self.event.synchronize()

            def ready(self):
                return self.event.query()
    ''',
    "gt004_torch_bad": '''
        import torch


        def shard_rows(x):
            n = x.sum().item()
            rows = x.tolist()
            host = x.cpu()
            torch.cuda.synchronize()
            return n, rows, host
    ''',
    "gt004_torch_ok": '''
        import torch


        def shard_rows(x, parts: int):
            n = int(x.shape[0]) // parts
            return [x[i * n:(i + 1) * n].contiguous() for i in range(parts)]
    ''',
    "gl002_torch_bad": '''
        import threading

        import torch


        def _pull(t: torch.Tensor):
            return t.tolist()


        class Sched:
            def __init__(self):
                self._lock = threading.Lock()
                self.load = torch.zeros(8)
                self.event = torch.cuda.Event()

            def snapshot(self):
                with self._lock:
                    return self.load.cpu()

            def total(self, x: torch.Tensor):
                with self._lock:
                    return x.item()

            def wait(self):
                with self._lock:
                    self.event.synchronize()

            def drain(self):
                with self._lock:
                    torch.cuda.synchronize()

            def stream(self):
                with self._lock:
                    torch.cuda.current_stream().synchronize()

            def via_helper(self):
                with self._lock:
                    return _pull(self.load)
    ''',
    "gl002_torch_ok": '''
        import threading

        import numpy as np
        import torch


        class Sched:
            def __init__(self):
                self._lock = threading.Lock()
                self.load = torch.zeros(8)

            def _apply_releases(self, slots, costs):
                # Scheduler._apply_releases: numpy arrays under the lock.
                with self._lock:
                    idx, inv = np.unique(slots, return_inverse=True)
                    sums = np.zeros(len(idx), np.float32)
                    np.add.at(sums, inv, costs)
                    host = np.asarray(costs)
                    return list(zip(idx.tolist(), sums)), host.tolist()

            def snapshot(self):
                with self._lock:
                    snap = self.load.clone()
                return snap.cpu()
    ''',
}


@pytest.fixture
def torch_tree(tmp_path):
    cfg = tmp_path / "lockorder.toml"
    cfg.write_text(TORCH_CONFIG)
    paths = {}
    for stem, src in SOURCES.items():
        p = tmp_path / f"{stem}.py"
        p.write_text(textwrap.dedent(src).lstrip())
        paths[stem] = str(p)
    return paths, str(cfg)


def _run(torch_tree, stem: str, rule: str) -> list[Violation]:
    paths, cfg = torch_tree
    got, stale = run_paths([paths[stem]], config=cfg, baseline_path="",
                           rules={rule})
    assert stale == []
    return [v for v in got if v.file != "lockorder.toml"]


@pytest.mark.parametrize("stem,rule,expected", [
    ("gt001_torch_bad", "GT001", [
        "[_ON_CARD] torch.zeros(device=<cuda>)",
        "[_MOVED] .cuda()",
        "[_TO] .to(<cuda device>)",
        "[_DEV] torch.cuda.current_device()",
        "[_STREAM] torch.cuda.Stream()",
        "[<module>] gie_tpu_torch.ops.build.library() (kernel build)",
        "[Holder.EVENT] torch.cuda.Event()",
        "[pick(default)] torch.empty(device=<cuda>)",
    ]),
    ("gt002_torch_bad", "GT002", [
        "[Engine._cycle] time.perf_counter() inside captured code",
        "[Engine._cycle] torch.cuda.synchronize() inside captured code",
        "[Engine._cycle] numpy.asarray() inside captured code",
        "[_stage] torch.nonzero() inside captured code has a "
        "data-dependent output shape",
        "[_stage] torch.where() inside captured code has a data-dependent",
        "[_stage] torch.unique() inside captured code",
        "[_stage] .masked_select() inside captured code",
        "[_stage] .item() inside captured code",
        "[_stage] .tolist() inside captured code",
        "[_stage] .cpu() inside captured code",
        "[_stage] .numpy() inside captured code",
        "(called from capture via gt002_torch_bad.py:Engine._cycle)",
        "[_leaf] print() inside captured code",
        "[_leaf] float() on a tensor's value",
        "(called from capture via gt002_torch_bad.py:_stage)",
    ]),
    ("gt003_torch_bad", "GT003", [
        "[Wave.peek] synchronize() in production code",
        "[drain] synchronize() in production code",
        "[stream_wait] synchronize() in production code",
    ]),
    ("gt004_torch_bad", "GT004", [
        ".item() in the sharded-cycle layer",
        ".tolist() in the sharded-cycle layer",
        ".cpu() in the sharded-cycle layer",
        "synchronize() in the sharded-cycle layer",
    ]),
    ("gl002_torch_bad", "GL002", [
        "[Sched.snapshot] blocking call torch.Tensor.cpu (device sync)",
        "[Sched.total] blocking call torch.Tensor.item (device sync)",
        "[Sched.wait] blocking call torch.cuda.Event.synchronize "
        "(device sync)",
        "[Sched.drain] blocking call torch.cuda.synchronize (device sync)",
        "[Sched.stream] blocking call torch.cuda.Stream.synchronize "
        "(device sync)",
        "[Sched.via_helper] blocking call torch.Tensor.tolist (device sync) "
        "while holding gl002_torch_bad.Sched._lock via "
        "gl002_torch_bad.py:_pull",
    ]),
])
def test_torch_rule_fires_on_golden_violation(torch_tree, stem, rule,
                                               expected):
    got = _run(torch_tree, stem, rule)
    rendered = "\n".join(v.render() for v in got)
    for sub in expected:
        assert sub in rendered, f"{rule} on {stem} missing {sub!r}:\n{rendered}"
    assert len(got) == len(expected) - sum(
        s.startswith("(called") for s in expected), rendered


@pytest.mark.parametrize("stem,rule", [
    ("gt001_torch_ok", "GT001"),
    ("gt002_torch_ok", "GT002"),
    ("gt003_torch_ok", "GT003"),
    ("gt004_torch_ok", "GT004"),
    ("gl002_torch_ok", "GL002"),
])
def test_torch_rule_silent_on_negative(torch_tree, stem, rule):
    got = _run(torch_tree, stem, rule)
    assert got == [], "\n".join(v.render() for v in got)


def test_gt002_off_the_capture_path_and_behind_a_stop_is_silent(torch_tree):
    got = _run(torch_tree, "gt002_torch_bad", "GT002")
    assert not any(v.qualname in ("Engine.off_path", "_load_once")
                   for v in got)


def test_gt002_static_float_args_are_exempt(torch_tree):
    """float(n) of a shape, of an int-annotated parameter and of a
    parameter defaulting to a constant stay silent; float(x.sum()) does
    not."""
    got = _run(torch_tree, "gt002_torch_bad", "GT002")
    floats = [v for v in got if "float()" in v.message]
    assert [v.qualname for v in floats] == ["_leaf"]


def test_numpy_tolist_under_a_lock_is_not_a_device_pull(torch_tree):
    """The trouble spot: Scheduler._apply_releases calls idx.tolist() on
    a numpy array under _lock; only a receiver inferred to be a tensor
    matches torch.Tensor.tolist."""
    assert _run(torch_tree, "gl002_torch_ok", "GL002") == []
    idx = RepoIndex.build(os.path.join(REPO, "gie_tpu_torch"),
                          package_prefix="gie_tpu_torch.")
    fi = idx.modules["gie_tpu_torch.sched.profile"].classes[
        "Scheduler"].methods["_apply_releases"]
    tolist = [cs for cs in fi.calls.values() if cs.method == "tolist"]
    assert tolist and all(cs.ext is None for cs in tolist)


def test_stale_capture_root_and_allow_entries_fail(torch_tree, tmp_path):
    paths, cfg = torch_tree
    text = open(cfg).read().replace(
        '"gt002_torch_ok.Engine._cycle",',
        '"gt002_torch_ok.Engine._cycle", "gt002_torch_ok.Engine._gone",')
    text += '"gt003_torch_ok.py:Wave.ready" = "stale"\n'
    stale_cfg = tmp_path / "stale.toml"
    stale_cfg.write_text(text)
    got, _ = run_paths([paths["gt002_torch_ok"]], config=str(stale_cfg),
                       baseline_path="", rules={"GT002"})
    assert sorted(v.qualname for v in got if v.file == "stale.toml") == [
        "gt002_torch_bad.Engine._cycle", "gt002_torch_bad.py:_load_once",
        "gt002_torch_ok.Engine._gone"]
    got, _ = run_paths([paths["gt003_torch_ok"]], config=str(stale_cfg),
                       baseline_path="", rules={"GT003"})
    assert sorted(v.qualname for v in got) == [
        "gt003_torch_bad.py:Wave._wait", "gt003_torch_ok.py:Wave.ready"]


def test_allow_entry_without_a_reason_is_a_config_error(torch_tree,
                                                         tmp_path):
    paths, cfg = torch_tree
    bad = tmp_path / "noreason.toml"
    bad.write_text(open(cfg).read() + '"gt003_torch_ok.py:Wave.x" = " "\n')
    with pytest.raises(ValueError, match="needs a reason"):
        run_paths([paths["gt003_torch_ok"]], config=str(bad),
                  baseline_path="")


# --------------------------------------------------------------------------
# The port's own tree
# --------------------------------------------------------------------------


def test_gie_tpu_torch_clean_modulo_baseline():
    violations, stale = run_paths()
    assert violations == [], (
        "gie_tpu_torch/ has unbaselined lint findings — fix them or "
        "grandfather WITH justification in gie_tpu_torch/lint/baseline.toml:"
        "\n" + "\n".join(v.render() for v in violations))
    assert stale == [], "\n".join(f"{e.rule} at {e.where}" for e in stale)


def test_every_port_lock_is_ranked_and_no_rank_is_stale():
    idx = RepoIndex.build(os.path.join(REPO, "gie_tpu_torch"),
                          package_prefix="gie_tpu_torch.")
    ranks = tomlmini.load(DEFAULT_CONFIG)["ranks"]
    assert set(idx.locks) == set(ranks)
    for name in ("gie_tpu_torch.sched.profile.Scheduler._queue_lock",
                 "gie_tpu_torch.models.latency.OnlineTrainer._train_lock",
                 "gie_tpu_torch.runtime.metrics._Metric._lock",
                 "gie_tpu_torch.metricsio.scrape."
                 "ThreadPerEndpointScraper._lock",
                 "gie_tpu_torch.lint.dynamic.LockTracker._mu"):
        assert name in idx.locks
    # _queue_lock nests inside _lock (apply_prefix_events, evict_endpoint).
    assert (ranks["gie_tpu_torch.sched.profile.Scheduler._lock"]
            < ranks["gie_tpu_torch.sched.profile.Scheduler._queue_lock"])
    assert (ranks["gie_tpu_torch.models.latency.OnlineTrainer._train_lock"]
            < ranks["gie_tpu_torch.models.latency.OnlineTrainer._lock"])


def test_capture_roots_exist_and_reach_the_kernels():
    cfg = tomlmini.load(DEFAULT_CONFIG)
    idx = RepoIndex.build(os.path.join(REPO, "gie_tpu_torch"),
                          package_prefix="gie_tpu_torch.")
    roots = cfg["tracesafe"]["capture_roots"]
    assert roots and all(tracesafe._find_function(idx, r) for r in roots)
    tracesafe.run(idx, cfg)
    captured = {fi.where for fi in idx.all_functions() if fi.capture_chain}
    for where in ("sched/profile.py:scheduling_cycle",
                  "sched/sinkhorn.py:sinkhorn_picker",
                  "ops/fused_sinkhorn.py:fused_sinkhorn_plan",
                  "ops/fused_topk.py:fused_blend_topk",
                  "sched/prefix.py:ingest_lanes"):
        assert where in captured, where
    assert "ops/build.py:_compile" not in captured     # behind the stop


def test_port_baseline_entries_carry_justifications():
    entries = baseline.load(DEFAULT_BASELINE)
    assert entries and all(e.justification for e in entries)
    assert {e.rule for e in entries} == {"GL002"}
    assert all("ops/build.py:_compile" in e.match for e in entries)


# --------------------------------------------------------------------------
# Baseline machinery and the CLI
# --------------------------------------------------------------------------


def _violation(rule="GL002", where="f.py:C.m", msg="blocking call x"):
    file, qualname = where.rsplit(":", 1)
    return Violation(rule, file, 1, qualname, msg)


def test_baseline_requires_justification(tmp_path):
    p = tmp_path / "baseline.toml"
    p.write_text('[[finding]]\nrule = "GL002"\nwhere = "f.py:C.m"\n'
                 'match = "x"\njustification = "   "\n')
    with pytest.raises(baseline.BaselineError, match="justification"):
        baseline.load(str(p))


def test_baseline_covers_reports_stale_and_admits_nothing_new(tmp_path):
    p = tmp_path / "baseline.toml"
    p.write_text(
        '[[finding]]\nrule = "GL002"\nwhere = "f.py:C.m"\n'
        'match = "blocking"\njustification = "legacy"\n'
        '[[finding]]\nrule = "GL001"\nwhere = "gone.py:X.y"\n'
        'match = ""\njustification = "obsolete"\n')
    entries = baseline.load(str(p))
    remaining, stale = baseline.apply([_violation()], entries)
    assert remaining == []
    assert [e.where for e in stale] == ["gone.py:X.y"]
    new = _violation(where="other.py:D.n", msg="blocking call y")
    assert baseline.apply([new], entries)[0] == [new]


def test_rules_filter_does_not_strand_baseline_entries(tmp_path):
    p = tmp_path / "baseline.toml"
    p.write_text('[[finding]]\nrule = "GT003"\nwhere = "x.py:C.m"\n'
                 'match = "synchronize"\njustification = "legacy"\n')
    _, stale = run_paths([os.path.join(FIXTURES, "gl001_ok.py")],
                         config=FIXTURE_CONFIG, baseline_path=str(p),
                         rules={"GL"})
    assert stale == []


def test_cli_exit_codes(torch_tree, tmp_path):
    paths, cfg = torch_tree
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO

    def cli(*args):
        return subprocess.run([sys.executable, "-m", "gie_tpu_torch.lint",
                               *args], cwd=REPO, capture_output=True,
                              text=True, env=env, timeout=120)

    clean = cli()
    assert clean.returncode == 0, clean.stdout + clean.stderr
    assert "gie-lint: clean" in clean.stdout
    dirty = cli(paths["gl002_torch_bad"], "--config", cfg, "--no-baseline",
                "--rules", "GL002")
    assert dirty.returncode == 1, dirty.stdout + dirty.stderr
    assert "torch.Tensor.cpu (device sync)" in dirty.stdout
    broken = tmp_path / "broken.toml"
    broken.write_text("not a toml line\n")
    bad = cli(paths["gl002_torch_ok"], "--config", str(broken))
    assert bad.returncode == 2, bad.stdout + bad.stderr


def test_lint_package_imports_no_torch():
    """The analyzers are stdlib ast code: importing them (and running the
    CLI's analysis) pulls in neither torch nor jax."""
    code = ("import sys; import gie_tpu_torch.lint.runner, "
            "gie_tpu_torch.lint.dynamic; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'gie_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_tomlmini_subset_and_nested_tables():
    doc = tomlmini.loads(
        '# comment\ntop = "v"\n[ranks]\n"a.b.c" = 10\nplain = 2.5\n'
        'flag = true\n[blocking]\ncalls = [\n    "time.sleep",  # c\n'
        '    "json.loads",\n]\n[tracesafe.allow_functions]\n'
        '"f.py:C.m" = "why"\n[[finding]]\nrule = "GL001"\n'
        '[[finding]]\nrule = "GL002"\n')
    assert doc["top"] == "v"
    assert doc["ranks"] == {"a.b.c": 10, "plain": 2.5, "flag": True}
    assert doc["blocking"]["calls"] == ["time.sleep", "json.loads"]
    assert doc["tracesafe"]["allow_functions"] == {"f.py:C.m": "why"}
    assert [f["rule"] for f in doc["finding"]] == ["GL001", "GL002"]
    with pytest.raises(ValueError):
        tomlmini.loads("not a toml line\n")
    with pytest.raises(ValueError):
        tomlmini.loads("x = [1, 2\n")
