"""Conformance suite for the port (copy of the top-level conformance/
package over gie_tpu_torch).

The reference conformance tier (suite bootstrap, the Gateway-profile
tests' environment, report emission) against an in-process gateway
simulator driving the port's REAL EPP components: datastore, reconcilers,
StreamingServer and, in "tpu" mode, the batched Scheduler on its device.
The cases themselves live in tests/test_torch_conformance.py.
"""

from gie_tpu_torch.conformance.harness import ConformanceEnv
from gie_tpu_torch.conformance.report import ConformanceReport

__all__ = ["ConformanceEnv", "ConformanceReport"]
