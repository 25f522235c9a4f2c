"""gie-fleet, ported: the hierarchical two-level pick cycle for fleets past
the largest dense M bucket (port of gie_tpu/fleet; docs/FLEET.md).

  1. a COARSE stage over bounded per-cell rows (CellRows) emits the top-K
     candidate cells per request, and
  2. a candidate-COMPRESSED dense stage gathers the selected cells'
     endpoints into an [N, K*cell_cap] block and runs the port's
     unchanged scheduling cycle (and its kernels) over it.

Selected cells are gathered in ascending cell-id order, so whenever top-K
covers every cell the gather is the identity and the picks are bit-equal
to the dense cycle's.
"""

from gie_tpu_torch.fleet.cells import (
    CellRows,
    build_cell_rows,
    cell_match_from_table,
)
from gie_tpu_torch.fleet.coarse import coarse_total, select_cells
from gie_tpu_torch.fleet.compress import (
    broadcast_presence,
    compact_presence,
    gather_endpoints,
    global_slots,
)
from gie_tpu_torch.fleet.picker import FleetAux, FleetPicker, fleet_cycle

__all__ = [
    "CellRows",
    "FleetAux",
    "FleetPicker",
    "broadcast_presence",
    "build_cell_rows",
    "cell_match_from_table",
    "coarse_total",
    "compact_presence",
    "fleet_cycle",
    "gather_endpoints",
    "global_slots",
    "select_cells",
]
