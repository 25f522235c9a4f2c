"""gie_tpu_torch — the PyTorch/CUDA port of gie_tpu's scheduling core.

A second package beside `gie_tpu/` (the JAX reference, left unchanged).
It carries its own copy of everything it needs and imports nothing of
`gie_tpu` or JAX, so it runs on a machine that has only PyTorch.

Package map (mirrors gie_tpu's names):
  sched/      the batched scheduler: filters, scorers, prefix index,
              pickers, the Sinkhorn solve, the cycle and `Scheduler`
  ops/        hand-written Hopper kernels (CUDA C++ under ops/csrc/) with
              their plain PyTorch versions beside them
  convert.py  carries inputs and state across from/to the JAX package's
              numpy arrays
  utils/      test fixtures
  api/, controller/, bbr/, conformance/
              the kube slice: CRD types, CEL and CRDs, the kube watch
              adapter and pool status, body-based routing, and the
              conformance harness and suite over the port
(and the host layers of the other slices: extproc/, runtime/,
datastore/, metricsio/, resilience/, obs/, storm/, learn/,
replication/, autoscale/, federation/, fleet/, models/, simulator/)

Importing the package builds nothing: the kernels compile on first use on
a CUDA tensor (gie_tpu_torch/ops/build.py).
"""

__version__ = "0.1.0"
