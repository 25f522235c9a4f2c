"""The unified resilience layer (copy of gie_tpu/resilience, docs/RESILIENCE.md).

  faults    seeded deterministic fault injection — named fault points
            woven into the scrape engine and the scheduler dispatch
            path; strictly a module-flag check when disabled.
  policy    the ONE jittered-backoff/retry implementation the scrape
            engine's loops use.
  breaker   per-endpoint circuit breakers (error-streak open, half-open
            probe, hysteretic close) feeding the pick path's candidate
            filter and the scrape engine.
  deadline  request deadline propagation: Envoy header -> admission ->
            pick -> response; budget-exhausted requests shed with 503
            before they burn device cycles.
  ladder    the pick-path degradation ladder: full device pick ->
            bounded-staleness cached-snapshot pick -> weighted
            round-robin on last-known-good rows -> static subset,
            entered on dispatch errors / metrics blackout / sustained
            pick-latency breach / a pool-wide data-plane 5xx storm,
            exited hysteretically.
  scenarios recorded chaos scenarios: --fault specs grown into
            replayable JSON files (seed + rules + drive), shipped under
            resilience/scenarios/. Scenarios whose drive needs the storm
            twin or federation load here; those harnesses are not part
            of this package.
  outlier   p99 serve-latency outlier ejection: windowed per-endpoint
            latency quantile vs pool median tripping the breaker's
            serve plane (--outlier-ejection).
"""

from gie_tpu_torch.resilience.breaker import (        # noqa: F401
    BreakerBoard,
    BreakerConfig,
    BreakerState,
    CircuitBreaker,
)
from gie_tpu_torch.resilience.deadline import (       # noqa: F401
    DEADLINE_HEADERS,
    DeadlineExceeded,
    deadline_from_headers,
    remaining_s,
)
from gie_tpu_torch.resilience.faults import (         # noqa: F401
    CATALOG,
    FaultError,
    FaultInjector,
    FaultRule,
    Verdict,
)
from gie_tpu_torch.resilience.ladder import (         # noqa: F401
    DegradationLadder,
    LadderConfig,
    ResilienceState,
    Rung,
)
from gie_tpu_torch.resilience.outlier import (        # noqa: F401
    OutlierConfig,
    OutlierEjector,
)
from gie_tpu_torch.resilience.policy import (         # noqa: F401
    Backoff,
    BackoffPolicy,
    retry_call,
)
from gie_tpu_torch.resilience.scenarios import (      # noqa: F401
    Scenario,
    list_scenarios,
)
from gie_tpu_torch.resilience.scenarios import load as load_scenario  # noqa: F401
