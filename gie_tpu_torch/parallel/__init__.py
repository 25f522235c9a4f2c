"""Mesh and sharding: the scheduling cycle and the predictor's training
step over a (dp, tp) mesh of device positions (port of gie_tpu/parallel/)."""

from gie_tpu_torch.parallel.mesh import (
    Mesh,
    ShardedState,
    cycle_shardings,
    make_mesh,
    predictor_param_shardings,
    sharded_cycle,
    sharded_train_step,
    state_shardings,
)

__all__ = [
    "Mesh",
    "ShardedState",
    "cycle_shardings",
    "make_mesh",
    "predictor_param_shardings",
    "sharded_cycle",
    "sharded_train_step",
    "state_shardings",
]
