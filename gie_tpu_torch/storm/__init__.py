"""gie-storm on the port (port of gie_tpu/storm, docs/STORM.md).

Composable, seeded-deterministic traffic shapes compiled into
bit-identical-per-seed schedules (shapes.py) and executed against the
port's stack — ext-proc admission, flow queue, waves on the Scheduler's
device, breakers/ladder/drain/outlier ejection, scraping — in real or
virtual time, scored into the reference's JSON scorecard (scorecard.py).
``python -m gie_tpu_torch.storm <scenario> [--device cpu]`` replays a
recorded scenario whose ``drive`` carries a ``storm`` section; the search
harness is storm/search.py. The autoscale loop, the replication standby
probe, the learned scorer, federation (a peer cluster's stub fleet
imported through the real exchange), the fleet picker and the mesh
(``mesh_devices``) run as in the reference.
"""

from gie_tpu_torch.storm.engine import (          # noqa: F401
    EngineConfig,
    PoolSpec,
    StormEngine,
    StormResult,
    run_scenario,
)
from gie_tpu_torch.storm.scorecard import (       # noqa: F401
    SCHEMA as SCORECARD_SCHEMA,
    score_completions,
)
from gie_tpu_torch.storm.shapes import (          # noqa: F401
    Arrival,
    ConstantRate,
    ControlEvent,
    DiurnalRamp,
    FlashCrowd,
    LongContextMix,
    LoraChurn,
    Program,
    RollingUpgrade,
    Schedule,
    Shape,
    StandbyFailover,
    TrafficConfig,
    program_from_drive,
    shapes_from_specs,
)
