"""(Copy of gie_tpu/resilience/faults.py, imports rewritten to gie_tpu_torch.)

gie-chaos: seeded, deterministic fault injection.

A fault POINT is a named seam in a subsystem where the real world fails:
a scrape fetch, a digest poll, a kube patch, a device dispatch. Each
point is declared in :data:`CATALOG` (the coverage meta-test in
tests/test_fault_coverage.py walks it — an injection site cannot land
without a test exercising it) and woven into its subsystem as

    if faults.ENABLED:
        faults.check("scrape.fetch", key=ep.url)

so the disabled cost is exactly one module-attribute load and a falsy
branch — nothing else, no function call, no dict lookup (the
bench-extproc regression guard pins this for the admission path).

Determinism: every (point, key) pair draws verdicts from its OWN
``random.Random`` stream seeded by ``(seed, point, key)``. Thread
interleaving across endpoints/subsystems therefore cannot perturb any
single stream: two runs with the same seed and the same per-stream draw
counts produce bit-identical fault schedules, which is what lets the
chaos suite assert exact degradation/recovery traces.

Verdicts:

  ok       nothing happens
  error    raise :class:`FaultError` at the call site (the subsystem's
           real error path absorbs it — that's the point)
  latency  sleep ``latency_s`` then proceed
  hang     sleep ``hang_s`` (default far beyond any subsystem timeout)
  corrupt  returned to call sites that opt in via :func:`fire` — the
           site flips bytes / poisons its payload (e.g. the replication
           publisher serving a corrupted digest frame)
"""

from __future__ import annotations

import dataclasses
import random
import threading
from typing import Optional

from gie_tpu_torch.runtime import clock as clock_mod

# Fault-point catalog: name -> where it is woven. The injector refuses
# unknown names, and the coverage meta-test requires each entry to be
# exercised by at least one test.
CATALOG = {
    "scrape.fetch": "metrics scrape fetch (metricsio/engine.py _fetch)",
    "replication.poll": "follower digest fetch (replication/follower.py)",
    "replication.publish":
        "leader digest serve (replication/publisher.py serve)",
    "kube.patch": "autoscale actuator SSA patch (autoscale/actuator.py)",
    "native.scan": "native JSON field scan (extproc/fieldscan.py scan)",
    "device.dispatch":
        "scheduler device cycle dispatch + materialize (sched/batching.py)",
    "endpoint.slow": "per-endpoint added latency (metricsio/engine.py)",
    "endpoint.hang": "per-endpoint hang (metricsio/engine.py)",
    "endpoint.serve_5xx":
        "data-plane serve outcome forced to 503 at the ext-proc "
        "response-headers hop (extproc/server.py)",
    "endpoint.reset":
        "upstream stream reset before response headers — the abort-as-"
        "reset path (extproc/server.py)",
    "peer.poll":
        "federation peer digest long-poll — the flaky-link point "
        "(federation/exchange.py PeerLink.poll_once)",
    "peer.publish":
        "federation digest serve on the exchange listener "
        "(federation/exchange.py FederationPublisher.serve)",
    "peer.partition":
        "federation link severance, both directions — sustained "
        "partition of one peer (federation/exchange.py: PeerLink "
        "outbound + FederationHTTPServer inbound)",
}

OK = "ok"
ERROR = "error"
LATENCY = "latency"
HANG = "hang"
CORRUPT = "corrupt"

_KINDS = (ERROR, LATENCY, HANG, CORRUPT)

# THE hot-path flag. True only while an injector is installed; every
# woven site guards on it before touching anything else in this module.
ENABLED = False
_active: Optional["FaultInjector"] = None
_install_lock = threading.Lock()


class FaultError(ConnectionError):
    """The injected failure. Subclasses ConnectionError so sites whose
    real-world failure mode is network-shaped (fetch/poll/patch) absorb
    it through their existing handlers without special-casing."""

    def __init__(self, point: str, key: str = ""):
        super().__init__(f"injected fault at {point}"
                         + (f" [{key}]" if key else ""))
        self.point = point
        self.key = key


@dataclasses.dataclass(frozen=True)
class Verdict:
    kind: str
    sleep_s: float = 0.0


_OK = Verdict(OK)


@dataclasses.dataclass(frozen=True)
class FaultRule:
    """Probabilities per draw (summed mass must be <= 1; the remainder is
    ``ok``). ``keys``: restrict to draws whose key contains any of these
    substrings (None = every key). ``after``: the first N draws per
    stream are ok (lets a scenario establish healthy state first).
    ``max_fires``: total non-ok verdicts per stream before the rule goes
    quiet (bounds a scenario's blast radius deterministically)."""

    p_error: float = 0.0
    p_latency: float = 0.0
    p_hang: float = 0.0
    p_corrupt: float = 0.0
    latency_s: float = 0.05
    hang_s: float = 30.0
    keys: Optional[tuple] = None
    after: int = 0
    max_fires: Optional[int] = None

    def __post_init__(self):
        mass = self.p_error + self.p_latency + self.p_hang + self.p_corrupt
        if not (0.0 <= mass <= 1.0 + 1e-9):
            raise ValueError(f"fault probabilities sum to {mass}")

    def matches(self, key: str) -> bool:
        if self.keys is None:
            return True
        return any(k in key for k in self.keys)


class _Stream:
    """Per-(point, key) verdict stream: own RNG, own counters."""

    __slots__ = ("rng", "draws", "fires")

    def __init__(self, seed: int, point: str, key: str):
        self.rng = random.Random(f"{seed}/{point}/{key}")
        self.draws = 0
        self.fires = 0


class FaultInjector:
    """Seeded verdict source for a set of rules. Thread-safe; the log of
    (point, key, kind) tuples is the reproducibility artifact the chaos
    suite compares across same-seed runs."""

    def __init__(self, seed: int, rules: dict[str, FaultRule]):
        for point in rules:
            if point not in CATALOG:
                raise ValueError(
                    f"unknown fault point {point!r}; known: "
                    f"{sorted(CATALOG)}")
        self.seed = seed
        self.rules = dict(rules)
        self._streams: dict[tuple[str, str], _Stream] = {}
        self._lock = threading.Lock()
        self.log: list[tuple[str, str, str]] = []
        self.fired: dict[str, int] = {}

    def verdict(self, point: str, key: str = "") -> Verdict:
        rule = self.rules.get(point)
        if rule is None or not rule.matches(key):
            return _OK
        with self._lock:
            stream = self._streams.get((point, key))
            if stream is None:
                stream = _Stream(self.seed, point, key)
                self._streams[(point, key)] = stream
            stream.draws += 1
            if stream.draws <= rule.after:
                return _OK
            if (rule.max_fires is not None
                    and stream.fires >= rule.max_fires):
                return _OK
            r = stream.rng.random()
            edge = 0.0
            kind = OK
            for k, p in ((ERROR, rule.p_error), (LATENCY, rule.p_latency),
                         (HANG, rule.p_hang), (CORRUPT, rule.p_corrupt)):
                edge += p
                if r < edge:
                    kind = k
                    break
            if kind == OK:
                return _OK
            stream.fires += 1
            self.fired[point] = self.fired.get(point, 0) + 1
            self.log.append((point, key, kind))
        if kind == LATENCY:
            return Verdict(LATENCY, rule.latency_s)
        if kind == HANG:
            return Verdict(HANG, rule.hang_s)
        return Verdict(kind)


def install(injector: FaultInjector) -> None:
    """Arm the registry. Global on purpose: fault points are woven into
    module-level hot paths, and threading an injector handle through
    every constructor would tax the disabled case the registry promises
    costs one flag check."""
    global _active, ENABLED
    with _install_lock:
        _active = injector
        ENABLED = True


def uninstall() -> None:
    global _active, ENABLED
    with _install_lock:
        ENABLED = False
        _active = None


def installed() -> Optional[FaultInjector]:
    return _active


# Clock seam for the latency/hang sleeps (gie_tpu/runtime/clock.py):
# chaos delays are CLOCK-GOVERNED behavior, so a virtual-time storm
# (docs/STORM.md) must serve them from the virtual clock — the sleep is
# the injected fault. set_clock installs the engine's clock; uninstall
# of the engine restores the monotonic default.
_clock: clock_mod.Clock = clock_mod.MONOTONIC


def set_clock(clock: Optional[clock_mod.Clock]) -> None:
    global _clock
    _clock = clock if clock is not None else clock_mod.MONOTONIC


def fire(point: str, key: str = "") -> Verdict:
    """Draw a verdict, serving latency/hang sleeps here; ERROR and
    CORRUPT come back to the call site (sites that cannot corrupt treat
    CORRUPT via :func:`check`'s raise instead)."""
    inj = _active
    if inj is None:
        return _OK
    v = inj.verdict(point, key)
    if v.kind in (LATENCY, HANG):
        _clock.sleep(v.sleep_s)
    return v


def check(point: str, key: str = "") -> None:
    """The standard woven form: error/corrupt raise FaultError,
    latency/hang sleep, ok is free. Call only under ``if ENABLED:``."""
    v = fire(point, key)
    if v.kind in (ERROR, CORRUPT):
        raise FaultError(point, key)


def parse_spec(specs: list[str]) -> dict[str, FaultRule]:
    """CLI fault spec -> rules. Format per entry (repeatable flag):

        point=kind:prob[:arg][,kind:prob[:arg]...]

    e.g. ``scrape.fetch=error:0.2,latency:0.1:80ms``. The arg is a
    duration for latency/hang (ms suffix or seconds)."""
    rules: dict[str, FaultRule] = {}
    for spec in specs:
        point, sep, body = spec.partition("=")
        if not sep or point not in CATALOG:
            raise ValueError(f"bad fault spec {spec!r}")
        kw: dict = {}
        for part in body.split(","):
            bits = part.split(":")
            if len(bits) < 2:
                raise ValueError(f"bad fault spec entry {part!r}")
            kind, prob = bits[0], float(bits[1])
            if kind not in _KINDS:
                raise ValueError(f"unknown fault kind {kind!r}")
            kw[f"p_{kind}"] = prob
            if len(bits) > 2 and kind in (LATENCY, HANG):
                arg = bits[2]
                secs = (float(arg[:-2]) / 1000.0 if arg.endswith("ms")
                        else float(arg))
                kw["latency_s" if kind == LATENCY else "hang_s"] = secs
        rules[point] = FaultRule(**kw)
    return rules
