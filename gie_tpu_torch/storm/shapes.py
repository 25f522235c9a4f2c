"""(Copy of gie_tpu/storm/shapes.py, imports rewritten to gie_tpu_torch.)

gie-storm workload-shape primitives (docs/STORM.md).

A *shape* is one production traffic pattern, expressed as three
composable contributions:

  rate(t)            a multiplicative arrival-rate factor (diurnal ramp,
                     flash crowd) — factors from every shape in a
                     program MULTIPLY, so "diurnal valley x flash crowd"
                     means exactly that.
  decorate(a, rng, t) per-arrival attribute assignment (LoRA adapter
                     churn, long-context mix) — decorators CHAIN in the
                     order shapes are listed.
  control_events()   timed control-plane actions (rolling upgrade drain/
                     replace steps, a standby failover check) — events
                     from every shape UNION into one sorted timeline.

A :class:`Program` composes shapes over a :class:`TrafficConfig` and
compiles them into a :class:`Schedule`: the full arrival list plus the
control-event timeline. Compilation is SEEDED AND SINGLE-STREAM — one
``numpy`` generator, drawn in a fixed order — so the same (program,
seed) produces a bit-identical schedule on every machine, which is the
replay contract the storm suite asserts (``Schedule.fingerprint``).
The engine (storm/engine.py) then executes a schedule against the real
stack; determinism of the *schedule* is the pinned property (execution
interleaving is real threads against real subsystems, by design).
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
import zlib
from typing import Optional

import numpy as np

BANDS = ("critical", "standard", "sheddable")


@dataclasses.dataclass(frozen=True)
class Arrival:
    """One request the storm will inject."""

    t: float                  # storm seconds from run start
    session: int              # shared-system-prompt session id
    prompt_bytes: int
    decode_tokens: float      # TRUE generated length (engine-side secret)
    band: str = "standard"    # criticality band (objective header)
    lora: Optional[str] = None
    kind: str = "chat"        # "chat" | "long_context"
    # Fairness ID (x-gateway-inference-fairness-id); None = no header
    # (the engine's tallies bucket those as "default").
    tenant: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class ControlEvent:
    """One timed control-plane action the engine interprets."""

    t: float
    kind: str                 # "drain" | "replace" | "failover_check"
    args: tuple = ()          # hashable payload (pod index, ...)


@dataclasses.dataclass(frozen=True)
class TrafficConfig:
    """The base workload the shapes modulate."""

    base_qps: float = 40.0
    duration_s: float = 10.0
    n_sessions: int = 16
    system_prompt_bytes: int = 1024
    user_suffix_bytes: int = 96
    decode_tokens_mean: float = 24.0
    sheddable_fraction: float = 0.25
    critical_fraction: float = 0.05
    dt: float = 0.05          # arrival-bin width for the Poisson draw

    def __post_init__(self):
        if self.base_qps < 0 or self.duration_s <= 0 or self.dt <= 0:
            raise ValueError("traffic rates/durations must be positive")
        if not (0 <= self.sheddable_fraction + self.critical_fraction <= 1):
            raise ValueError("band fractions must sum within [0, 1]")


class Shape:
    """Base shape: identity rate, no decoration, no events."""

    def rate(self, t: float) -> float:
        return 1.0

    def decorate(self, a: dict, rng: np.random.Generator, t: float) -> None:
        pass

    def control_events(self, duration_s: float) -> list[ControlEvent]:
        return []


class ConstantRate(Shape):
    """Flat rate scaling — the unit of the composition algebra's
    multiplication (useful in tests and sweeps)."""

    def __init__(self, factor: float):
        if factor < 0:
            raise ValueError("rate factor must be >= 0")
        self.factor = factor

    def rate(self, t: float) -> float:
        return self.factor


class DiurnalRamp(Shape):
    """Smooth day-shaped load: floor at the valley, peak mid-period.
    ``rate = floor + (peak - floor) * (1 - cos(2*pi*(t+phase)/period))/2``.
    """

    def __init__(self, period_s: float = 20.0, floor: float = 0.3,
                 peak: float = 1.0, phase_s: float = 0.0):
        if period_s <= 0 or floor < 0 or peak < floor:
            raise ValueError("need period > 0 and 0 <= floor <= peak")
        self.period_s = period_s
        self.floor = floor
        self.peak = peak
        self.phase_s = phase_s

    def rate(self, t: float) -> float:
        x = (1.0 - math.cos(
            2.0 * math.pi * (t + self.phase_s) / self.period_s)) / 2.0
        return self.floor + (self.peak - self.floor) * x


class FlashCrowd(Shape):
    """A traffic spike: ramp to ``magnitude`` over ``ramp_s``, hold for
    ``hold_s``, decay back over ``decay_s``. Multiplies whatever the
    other shapes say the rate is (a flash crowd during a diurnal valley
    is magnitude x valley)."""

    def __init__(self, at_s: float = 2.0, ramp_s: float = 1.0,
                 hold_s: float = 3.0, magnitude: float = 3.0,
                 decay_s: Optional[float] = None):
        if magnitude < 1.0 or ramp_s < 0 or hold_s < 0:
            raise ValueError("flash crowd needs magnitude >= 1")
        self.at_s = at_s
        self.ramp_s = ramp_s
        self.hold_s = hold_s
        self.magnitude = magnitude
        self.decay_s = ramp_s if decay_s is None else decay_s

    def rate(self, t: float) -> float:
        dt = t - self.at_s
        if dt < 0:
            return 1.0
        if dt < self.ramp_s:
            return 1.0 + (self.magnitude - 1.0) * (dt / self.ramp_s)
        dt -= self.ramp_s
        if dt < self.hold_s:
            return self.magnitude
        dt -= self.hold_s
        if self.decay_s > 0 and dt < self.decay_s:
            return self.magnitude - (self.magnitude - 1.0) * (
                dt / self.decay_s)
        return 1.0

    def window(self) -> tuple[float, float]:
        """(start, end) of the elevated-rate window (ramp..decay)."""
        return (self.at_s,
                self.at_s + self.ramp_s + self.hold_s + self.decay_s)


class LoraChurn(Shape):
    """Multi-tenant LoRA adapter churn: a HOT set of ``hot`` adapters
    (out of ``adapters`` total) receives the adapter traffic; the hot
    window rotates every ``rotate_every_s`` so residency churns — the
    cold-load penalty and max_lora queueing the stubs model are what
    this shape is aimed at."""

    def __init__(self, adapters: int = 8, hot: int = 2,
                 rotate_every_s: float = 4.0, p: float = 0.7):
        if adapters < 1 or not (1 <= hot <= adapters) or not (0 <= p <= 1):
            raise ValueError("need adapters >= hot >= 1 and p in [0, 1]")
        self.adapters = adapters
        self.hot = hot
        self.rotate_every_s = rotate_every_s
        self.p = p

    def hot_set(self, t: float) -> list[str]:
        w = int(t // self.rotate_every_s)
        return [f"adapter-{(w * self.hot + i) % self.adapters}"
                for i in range(self.hot)]

    def decorate(self, a: dict, rng: np.random.Generator, t: float) -> None:
        # Fixed two draws per arrival regardless of outcome, so a churn
        # parameter change cannot shift every later draw in the stream.
        u = rng.random()
        pick = int(rng.integers(self.hot))
        if u < self.p:
            a["lora"] = self.hot_set(t)[pick]


class LongContextMix(Shape):
    """A long-context / pd-disaggregated-style slice: ``fraction`` of
    arrivals carry a long prompt (prefill-heavy) and a scaled decode
    (decode-heavy tail) — the mix that separates prefill and decode
    pressure the way a pd-disaggregated pool would see it."""

    def __init__(self, fraction: float = 0.15, prompt_bytes: int = 8192,
                 decode_scale: float = 2.0):
        if not (0 <= fraction <= 1) or prompt_bytes < 1:
            raise ValueError("need fraction in [0, 1], prompt_bytes >= 1")
        self.fraction = fraction
        self.prompt_bytes = prompt_bytes
        self.decode_scale = decode_scale

    def decorate(self, a: dict, rng: np.random.Generator, t: float) -> None:
        if rng.random() < self.fraction:
            a["kind"] = "long_context"
            a["prompt_bytes"] = self.prompt_bytes
            a["decode_tokens"] = a["decode_tokens"] * self.decode_scale


class TenantMix(Shape):
    """Zipf tenant assignment (gie-fair, docs/FAIRNESS.md): arrival i
    belongs to tenant ``t<k>`` with probability proportional to
    ``1/(k+1)^zipf_a`` — the head-heavy population a real multi-tenant
    gateway serves. One fixed draw per arrival (determinism contract).
    Compose BEFORE the abusive/pinned tenant decorators, which override
    a slice of the mix."""

    def __init__(self, tenants: int = 8, zipf_a: float = 1.1,
                 prefix: str = "t"):
        if tenants < 1 or zipf_a < 0:
            raise ValueError("need tenants >= 1 and zipf_a >= 0")
        self.tenants = tenants
        self.zipf_a = zipf_a
        self.prefix = prefix
        raw = [1.0 / (k + 1) ** zipf_a for k in range(tenants)]
        total = sum(raw)
        cum, acc = [], 0.0
        for w in raw:
            acc += w / total
            cum.append(acc)
        self._cum = cum

    def decorate(self, a: dict, rng: np.random.Generator, t: float) -> None:
        u = rng.random()
        for k, edge in enumerate(self._cum):
            if u < edge:
                a["tenant"] = f"{self.prefix}{k}"
                return
        a["tenant"] = f"{self.prefix}{self.tenants - 1}"


class PinnedTenant(Shape):
    """A dedicated tenant owning a fixed ``share`` of arrivals, with a
    pinned criticality band — the latency-sensitive CRITICAL tenant
    riding through a batch tenant's flash crowd. Assigns tenant AND band
    together so a later abusive decorator stealing the arrival cannot
    leave an orphaned CRITICAL band on the abuser's traffic. One fixed
    draw per arrival."""

    def __init__(self, tenant: str = "vip", share: float = 0.05,
                 band: str = "critical"):
        if not (0.0 <= share <= 1.0) or band not in BANDS:
            raise ValueError(f"need share in [0, 1] and band in {BANDS}")
        self.tenant = tenant
        self.share = share
        self.band = band

    def decorate(self, a: dict, rng: np.random.Generator, t: float) -> None:
        if rng.random() < self.share:
            a["tenant"] = self.tenant
            a["band"] = self.band


class AbusiveTenant(Shape):
    """One tenant multiplies its OWN arrival rate by ``rate_x`` inside a
    flash-crowd-shaped window while every other tenant's absolute rate
    stays unchanged: the global rate scales by ``m = 1 + share*(x-1)``
    and a matching fraction ``share*x/m`` of arrivals is reassigned to
    the abuser (the algebra keeps victims' rates exactly constant —
    docs/FAIRNESS.md "noisy neighbor"). Reassigned arrivals also
    re-draw their band from the abuser's own mix (a batch tenant:
    mostly sheddable/standard, never critical), so a stolen CRITICAL
    arrival cannot smuggle unsheddable priority into the flood. Two
    fixed draws per arrival. Compose AFTER TenantMix/PinnedTenant."""

    def __init__(self, tenant: str = "abuser", share: float = 0.1,
                 rate_x: float = 20.0, at_s: float = 0.0,
                 ramp_s: float = 0.5, hold_s: float = 4.0,
                 decay_s: Optional[float] = None,
                 sheddable_fraction: float = 0.7):
        if not (0.0 < share < 1.0) or rate_x < 1.0:
            raise ValueError("need share in (0, 1) and rate_x >= 1")
        if ramp_s < 0 or hold_s < 0:
            raise ValueError("window durations must be >= 0")
        if not (0.0 <= sheddable_fraction <= 1.0):
            raise ValueError("sheddable_fraction must be in [0, 1]")
        self.tenant = tenant
        self.share = share
        self.rate_x = rate_x
        self.at_s = at_s
        self.ramp_s = ramp_s
        self.hold_s = hold_s
        self.decay_s = ramp_s if decay_s is None else decay_s
        self.sheddable_fraction = sheddable_fraction

    def _x(self, t: float) -> float:
        """Current rate multiplier for the abuser's own traffic."""
        dt = t - self.at_s
        if dt < 0:
            return 1.0
        if dt < self.ramp_s:
            return 1.0 + (self.rate_x - 1.0) * (dt / self.ramp_s)
        dt -= self.ramp_s
        if dt < self.hold_s:
            return self.rate_x
        dt -= self.hold_s
        if self.decay_s > 0 and dt < self.decay_s:
            return self.rate_x - (self.rate_x - 1.0) * (dt / self.decay_s)
        return 1.0

    def rate(self, t: float) -> float:
        return 1.0 + self.share * (self._x(t) - 1.0)

    def window(self) -> tuple[float, float]:
        return (self.at_s,
                self.at_s + self.ramp_s + self.hold_s + self.decay_s)

    def decorate(self, a: dict, rng: np.random.Generator, t: float) -> None:
        # Two fixed draws regardless of outcome (determinism contract).
        u = rng.random()
        ub = rng.random()
        x = self._x(t)
        m = 1.0 + self.share * (x - 1.0)
        if u < self.share * x / m:
            a["tenant"] = self.tenant
            a["band"] = ("sheddable" if ub < self.sheddable_fraction
                         else "standard")


class RollingUpgrade(Shape):
    """Sequential drain/replace of every pod under traffic: pod ``i``
    is DRAINED at ``start_s + i*interval_s`` and REPLACED ``settle_s``
    later (the settle window is what lets in-flight streams finish on
    the old pod). Pure control-plane shape — rate 1.0."""

    def __init__(self, start_s: float = 3.0, pods: int = 4,
                 interval_s: float = 1.5, settle_s: float = 1.0):
        if pods < 1 or interval_s <= 0 or settle_s < 0:
            raise ValueError("need pods >= 1 and positive intervals")
        if settle_s >= interval_s:
            # Two pods draining at once halves the pool mid-upgrade; the
            # shape models the one-at-a-time rollout a Deployment does.
            raise ValueError("settle_s must be < interval_s")
        self.start_s = start_s
        self.pods = pods
        self.interval_s = interval_s
        self.settle_s = settle_s

    def control_events(self, duration_s: float) -> list[ControlEvent]:
        out = []
        for i in range(self.pods):
            t0 = self.start_s + i * self.interval_s
            if t0 + self.settle_s >= duration_s:
                break  # an upgrade step the run cannot finish is skipped
            out.append(ControlEvent(t0, "drain", (i,)))
            out.append(ControlEvent(t0 + self.settle_s, "replace", (i,)))
        return out

    def end_s(self) -> float:
        return self.start_s + (self.pods - 1) * self.interval_s \
            + self.settle_s


class ClusterDrain(Shape):
    """Whole-cluster graceful drain (gie-fed, docs/FEDERATION.md): at
    ``at_s`` the engine raises the federation drain flag — new picks
    bleed to healthy peer clusters, in-flight streams complete locally,
    and the flag publishes to peers so they stop spilling in. Pure
    control-plane shape — rate 1.0."""

    def __init__(self, at_s: float = 3.0):
        if at_s < 0:
            raise ValueError("at_s must be >= 0")
        self.at_s = at_s

    def control_events(self, duration_s: float) -> list[ControlEvent]:
        if self.at_s >= duration_s:
            return []
        return [ControlEvent(self.at_s, "cluster_drain", ())]


class PeerPartition(Shape):
    """Sever the federation exchange link to the peer cluster at
    ``at_s`` and heal it at ``heal_s`` (gie-fed). With ``flip_era`` the
    peer's publisher re-mints a GREATER era during the partition (the
    far side failed over its EPP) and the OLD lineage keeps answering
    interleaved after the heal — the split-brain storm whose
    deterministic convergence (installed era ratchets to max, zombie
    frames reject as era regressions) the scorecard pins."""

    def __init__(self, at_s: float = 2.0, heal_s: float = 6.0,
                 flip_era: bool = True):
        if not (0 <= at_s < heal_s):
            raise ValueError("need 0 <= at_s < heal_s")
        self.at_s = at_s
        self.heal_s = heal_s
        self.flip_era = flip_era

    def control_events(self, duration_s: float) -> list[ControlEvent]:
        out = []
        if self.at_s < duration_s:
            out.append(ControlEvent(self.at_s, "peer_partition", ()))
        if self.heal_s < duration_s:
            out.append(ControlEvent(
                self.heal_s, "peer_heal", (1 if self.flip_era else 0,)))
        return out


class TraceReplay(Shape):
    """Replay RECORDED traffic (gie-twin, docs/STORM.md "trace replay"):
    arrival timestamps plus the prompt-length / decode-hint / band /
    tenant / adapter mix straight from a flight-recorder dump
    (obs/recorder.py ``load_records`` — the artifacts every chaos/storm
    run and the ``--obs-dump-dir`` shutdown hook already write). Where
    the synthetic shapes model a workload, this one IS the workload: a
    production incident's decision records become a storm program, and
    under ``virtual_time`` a day of recorded traffic replays in minutes
    against any candidate policy (the Tesserae-style trace-driven
    evaluation PAPERS.md points at).

    Composition: a TraceReplay REPLACES the Poisson arrival draw —
    recorded arrivals are literal, so other shapes' ``rate``/``decorate``
    contributions do not apply to them; control-plane shapes (rolling
    upgrade, partitions, failover probes) still compose, which is
    exactly the "replay yesterday's traffic through tomorrow's upgrade"
    experiment. Multiple replays union their arrivals.

    Record mapping: ``ts`` (wall seconds; the dump's first record is
    t=0, spacing scaled by ``time_scale``), ``prompt_bytes`` /
    ``decode_tokens`` / ``tenant`` (recorded since gie-twin; older
    dumps fall back to the defaults), ``band`` verbatim, ``model`` !=
    ``base_model`` becomes the LoRA adapter, and the session id is a
    stable CRC of the trace ID so recorded prefix-affinity structure
    survives the replay."""

    def __init__(self, records: Optional[list] = None,
                 path: Optional[str] = None, time_scale: float = 1.0,
                 base_model: str = "base-model",
                 default_prompt_bytes: int = 1024,
                 default_decode_tokens: float = 16.0):
        if (records is None) == (path is None):
            raise ValueError(
                "TraceReplay needs exactly one of records= / path=")
        if time_scale <= 0:
            raise ValueError("time_scale must be > 0")
        if path is not None:
            from gie_tpu_torch.obs.recorder import load_records

            with open(path, "r", encoding="utf-8") as fh:
                records = load_records(fh.read())
        rows = []
        for rec in records:
            ts = rec.get("ts")
            if isinstance(ts, (int, float)):
                rows.append((float(ts), rec))
        if not rows:
            raise ValueError(
                "trace-replay dump has no timestamped records")
        rows.sort(key=lambda r: r[0])
        t0 = rows[0][0]
        self._arrivals: list[dict] = []
        for i, (ts, rec) in enumerate(rows):
            band = rec.get("band")
            model = rec.get("model")
            tenant = rec.get("tenant")
            trace_id = rec.get("trace_id") or ""
            session = (zlib.crc32(trace_id.encode("utf-8", "replace"))
                       if trace_id else i)
            self._arrivals.append({
                "t": round((ts - t0) * time_scale, 6),
                "session": int(session),
                "prompt_bytes": int(
                    rec.get("prompt_bytes") or default_prompt_bytes),
                "decode_tokens": float(
                    rec.get("decode_tokens") or default_decode_tokens),
                "band": band if band in BANDS else "standard",
                "lora": (model if (isinstance(model, str) and model
                                   and model != base_model) else None),
                "kind": "chat",
                "tenant": tenant if tenant else None,
            })

    def replay_arrivals(self, tc: "TrafficConfig") -> list[dict]:
        """The literal arrival rows, sessions folded into the program's
        session space (prefix-affinity structure preserved modulo
        n_sessions)."""
        return [dict(a, session=a["session"] % max(tc.n_sessions, 1))
                for a in self._arrivals]

    def duration_s(self) -> float:
        return self._arrivals[-1]["t"] if self._arrivals else 0.0


class StandbyFailover(Shape):
    """Warm-standby sync checkpoints: at each event the engine publishes
    the live scheduler's replication digest and has a follower fetch +
    decode it (the failover-readiness probe of docs/REPLICATION.md) —
    proving the standby would promote WARM at that instant of the
    storm."""

    def __init__(self, every_s: float = 2.0, start_s: float = 1.0):
        if every_s <= 0:
            raise ValueError("every_s must be > 0")
        self.every_s = every_s
        self.start_s = start_s

    def control_events(self, duration_s: float) -> list[ControlEvent]:
        out = []
        t = self.start_s
        while t < duration_s:
            out.append(ControlEvent(t, "failover_check", ()))
            t += self.every_s
        return out


@dataclasses.dataclass(frozen=True)
class Schedule:
    """A compiled storm: the deterministic artifact the engine replays."""

    arrivals: tuple
    events: tuple
    seed: int
    traffic: TrafficConfig

    def fingerprint(self) -> str:
        """Stable digest of the full schedule — two compiles of the same
        (program, seed) must agree bit-for-bit (the determinism claim
        tests/test_storm.py pins)."""
        h = hashlib.sha256()
        for a in self.arrivals:
            h.update(repr(dataclasses.astuple(a)).encode())
        for e in self.events:
            h.update(repr(dataclasses.astuple(e)).encode())
        return h.hexdigest()


class Program:
    """Shapes composed over a base traffic config. ``compile()`` is the
    only place randomness happens; everything downstream replays the
    compiled schedule."""

    def __init__(self, traffic: TrafficConfig, shapes: list[Shape],
                 seed: int = 0):
        self.traffic = traffic
        self.shapes = list(shapes)
        self.seed = seed

    def rate(self, t: float) -> float:
        r = 1.0
        for s in self.shapes:
            r *= s.rate(t)
        return r

    def compile(self) -> Schedule:
        tc = self.traffic
        replays = [s for s in self.shapes if isinstance(s, TraceReplay)]
        if replays:
            # Recorded arrivals are LITERAL: they replace the Poisson
            # draw, and other shapes' rate/decorate contributions do not
            # re-shape them (control-plane shapes still compose — their
            # events union below). The duration stretches to cover the
            # replay so a dump longer than the configured window is
            # never silently truncated.
            rows: list[dict] = []
            for shape in replays:
                rows.extend(shape.replay_arrivals(tc))
            rows.sort(key=lambda a: (a["t"], a["session"]))
            arrivals = [Arrival(**a) for a in rows]
            end = max((a.t for a in arrivals), default=0.0)
            if end >= tc.duration_s:
                tc = dataclasses.replace(
                    tc, duration_s=round(end + 1.0, 6))
            events: list[ControlEvent] = []
            for shape in self.shapes:
                events.extend(shape.control_events(tc.duration_s))
            events.sort(key=lambda e: (e.t, e.kind, e.args))
            return Schedule(arrivals=tuple(arrivals), events=tuple(events),
                            seed=self.seed, traffic=tc)
        rng = np.random.default_rng(self.seed)
        arrivals: list[Arrival] = []
        t = 0.0
        while t < tc.duration_s:
            lam = tc.base_qps * self.rate(t) * tc.dt
            n = int(rng.poisson(lam)) if lam > 0 else 0
            for _ in range(n):
                # Fixed draw order per arrival — the determinism contract.
                off = float(rng.random()) * tc.dt
                session = int(rng.integers(tc.n_sessions))
                decode = float(max(rng.exponential(
                    tc.decode_tokens_mean), 4.0))
                ub = float(rng.random())
                band = ("sheddable" if ub < tc.sheddable_fraction
                        else "critical"
                        if ub < tc.sheddable_fraction + tc.critical_fraction
                        else "standard")
                a = {
                    "t": round(t + off, 6),
                    "session": session,
                    "prompt_bytes": tc.system_prompt_bytes
                    + tc.user_suffix_bytes,
                    "decode_tokens": decode,
                    "band": band,
                    "lora": None,
                    "kind": "chat",
                    "tenant": None,
                }
                for shape in self.shapes:
                    shape.decorate(a, rng, t)
                arrivals.append(Arrival(**a))
            t = round(t + tc.dt, 9)
        events: list[ControlEvent] = []
        for shape in self.shapes:
            events.extend(shape.control_events(tc.duration_s))
        events.sort(key=lambda e: (e.t, e.kind, e.args))
        return Schedule(arrivals=tuple(arrivals), events=tuple(events),
                        seed=self.seed, traffic=tc)


# -- JSON drive-section interpretation (resilience/scenarios.py) ----------

SHAPE_KINDS = {
    "constant": ConstantRate,
    "diurnal": DiurnalRamp,
    "flash_crowd": FlashCrowd,
    "lora_churn": LoraChurn,
    "long_context": LongContextMix,
    "rolling_upgrade": RollingUpgrade,
    "standby_failover": StandbyFailover,
    "tenant_mix": TenantMix,
    "pinned_tenant": PinnedTenant,
    "abusive_tenant": AbusiveTenant,
    "cluster_drain": ClusterDrain,
    "peer_partition": PeerPartition,
    # path= form only from a drive section (records= is programmatic).
    "trace_replay": TraceReplay,
}


def shapes_from_specs(specs: list[dict]) -> list[Shape]:
    """Shape list from a scenario file's ``drive.storm.shapes`` section:
    each entry is ``{"kind": <SHAPE_KINDS name>, ...constructor kwargs}``.
    Unknown kinds and kwargs are rejected loudly — a scenario file that
    silently dropped a shape would replay a different storm than it
    records."""
    out: list[Shape] = []
    for spec in specs:
        if not isinstance(spec, dict) or "kind" not in spec:
            raise ValueError(
                f"storm shape spec must be an object with 'kind': {spec!r}")
        kind = spec["kind"]
        cls = SHAPE_KINDS.get(kind)
        if cls is None:
            raise ValueError(
                f"unknown storm shape kind {kind!r}; known: "
                f"{sorted(SHAPE_KINDS)}")
        kwargs = {k: v for k, v in spec.items() if k != "kind"}
        try:
            out.append(cls(**kwargs))
        except TypeError as e:
            raise ValueError(f"bad kwargs for shape {kind!r}: {e}") from None
    return out


def program_from_drive(storm: dict, seed: int) -> Program:
    """``drive.storm`` section -> Program. The section's ``traffic``
    object maps onto TrafficConfig fields; ``base_qps``/``duration_s``
    may also sit at the top level for readability."""
    traffic_kw = dict(storm.get("traffic") or {})
    for k in ("base_qps", "duration_s"):
        if k in storm:
            traffic_kw[k] = storm[k]
    unknown = set(traffic_kw) - {
        f.name for f in dataclasses.fields(TrafficConfig)}
    if unknown:
        raise ValueError(
            f"unknown storm traffic fields {sorted(unknown)}")
    tc = TrafficConfig(**traffic_kw)
    return Program(tc, shapes_from_specs(storm.get("shapes") or []),
                   seed=seed)
