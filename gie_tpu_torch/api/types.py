"""API constants the port's data layer reads (from gie_tpu/api/types.py and
gie_tpu/api/objectives.py). The InferencePool object model comes with the
controller slice of the port."""

from __future__ import annotations

from gie_tpu_torch.sched.constants import Criticality

GROUP = "inference.networking.k8s.io"

# Annotation enabling per-pod DP-rank port filtering
# (reference pkg/lwepp/datastore/datastore.go:59-64).
ACTIVE_PORTS_ANNOTATION = f"{GROUP}/active-ports"
# Pod label declaring the serving role for disaggregated prefill/decode
# ("prefill" | "decode" | "both"/absent).
ROLE_LABEL = f"{GROUP}/role"

# Literal band names accepted in the objective header (gie_tpu keeps this
# map in api/objectives.py beside its ObjectiveRegistry).
LITERAL_BANDS = {
    "critical": int(Criticality.CRITICAL),
    "standard": int(Criticality.STANDARD),
    "sheddable": int(Criticality.SHEDDABLE),
}
