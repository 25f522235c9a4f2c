"""The versioned, checksummed gie-learn policy artifact (copy of
gie_tpu/learn/artifact.py; numpy and JSON only).

Wire shape (canonical JSON: sorted keys, compact separators, NaN
banned — byte-stable so "same dump + seed => identical artifact bytes"
is testable with ==):

    {
      "schema": "gie-learn-policy/1",
      "feature_schema": ["queue", "kv_cache", ...],   # ordered columns
      "weights": {"queue": {"hex": "0000803f", "value": 1.0}, ...},
      "provenance": {seed, fingerprints, trained_at, n_train, ...},
      "judgment": {...}  # optional: the twin judge's verdict + cards
      "checksum": "sha256:..."
    }

Weights travel as little-endian float32 hex (policy.float32_hex) — the
bit pattern IS the weight; the decimal ``value`` beside it is advisory
for humans and cross-checked at load so a hand-edit that changes one
but not the other is rejected rather than silently ignored. The
checksum is sha256 over the canonical JSON with the checksum field
removed, so any mutation (including judgment attachment) re-stamps.

Versioning follows the recorder's rule: the major bumps only when a
field CHANGES MEANING; loaders tolerate unknown additive fields, and a
newer major is rejected loudly (the runner must not route on weights
whose semantics it predates).
"""

from __future__ import annotations

import hashlib
import json
import numpy as np

from gie_tpu_torch.learn import policy

SCHEMA_FAMILY = "gie-learn-policy"
SCHEMA_MAJOR = 1
SCHEMA = f"{SCHEMA_FAMILY}/{SCHEMA_MAJOR}"

_REQUIRED = ("schema", "feature_schema", "weights", "provenance",
             "checksum")


def canonical_json(obj) -> str:
    """The one serialization every byte-stability claim rests on."""
    return json.dumps(obj, sort_keys=True, separators=(",", ":"),
                      allow_nan=False)


def compute_checksum(art: dict) -> str:
    body = {k: v for k, v in art.items() if k != "checksum"}
    digest = hashlib.sha256(canonical_json(body).encode()).hexdigest()
    return f"sha256:{digest}"


def build_artifact(
    weights: dict[str, float],
    feature_schema: tuple[str, ...],
    provenance: dict,
    judgment: dict | None = None,
) -> dict:
    """Assemble + checksum an artifact from trained weights. The weight
    table must cover exactly the feature schema's columns."""
    if set(weights) != set(feature_schema):
        raise ValueError(
            f"weights {sorted(weights)} do not match feature schema "
            f"{list(feature_schema)}")
    table = {}
    for name in feature_schema:
        w = np.float32(weights[name])
        table[name] = {"hex": policy.float32_hex(w), "value": float(w)}
    art = {
        "schema": SCHEMA,
        "feature_schema": list(feature_schema),
        "weights": table,
        "provenance": dict(provenance),
    }
    if judgment is not None:
        art["judgment"] = judgment
    art["checksum"] = compute_checksum(art)
    return art


def attach_judgment(art: dict, judgment: dict) -> dict:
    """Return a copy with the twin judge's verdict attached and the
    checksum re-stamped."""
    out = {k: v for k, v in art.items() if k != "checksum"}
    out["judgment"] = judgment
    out["checksum"] = compute_checksum(out)
    return out


def dumps_artifact(art: dict) -> str:
    return canonical_json(art)


def validate_artifact(art: dict) -> dict:
    """Structural + integrity validation. Returns the artifact. Raises
    ValueError with a load-bearing message on any defect."""
    if not isinstance(art, dict):
        raise ValueError("policy artifact must be a JSON object")
    missing = [k for k in _REQUIRED if k not in art]
    if missing:
        raise ValueError(f"policy artifact missing fields: {missing}")
    schema = str(art["schema"])
    family, _, major_text = schema.partition("/")
    if family != SCHEMA_FAMILY or not major_text.isdigit():
        raise ValueError(
            f"not a policy artifact (schema {schema!r}, "
            f"expected {SCHEMA_FAMILY}/<major>)")
    if int(major_text) > SCHEMA_MAJOR:
        raise ValueError(
            f"policy artifact schema {schema!r} is newer than this "
            f"build understands ({SCHEMA}); refusing to route on "
            "weights whose semantics may have changed")
    expected = compute_checksum(art)
    if art.get("checksum") != expected:
        raise ValueError(
            f"policy artifact checksum mismatch: stamped "
            f"{art.get('checksum')!r}, computed {expected!r}")
    feats = art["feature_schema"]
    if (not isinstance(feats, list) or not feats
            or not all(isinstance(f, str) for f in feats)):
        raise ValueError("feature_schema must be a non-empty name list")
    table = art["weights"]
    if not isinstance(table, dict) or set(table) != set(feats):
        raise ValueError(
            f"weight table columns {sorted(table) if isinstance(table, dict) else table!r} "
            f"do not match feature_schema {feats}")
    for name, entry in table.items():
        if not isinstance(entry, dict) or "hex" not in entry:
            raise ValueError(f"weight {name!r} missing bitwise hex form")
        bits = policy.float32_from_hex(str(entry["hex"]))
        value = entry.get("value")
        if not isinstance(value, (int, float)) or not np.isfinite(bits):
            raise ValueError(f"weight {name!r} is not a finite float32")
        if abs(float(bits) - float(value)) > 1e-5 * max(
                1.0, abs(float(bits))):
            raise ValueError(
                f"weight {name!r} decimal value {value} disagrees with "
                f"its hex bits {float(bits)} — refusing a half-edited "
                "artifact")
    return art


def loads_artifact(text: str) -> dict:
    return validate_artifact(json.loads(text))


def load_artifact(path: str) -> dict:
    with open(path) as f:
        return loads_artifact(f.read())


def validate_feature_schema(art: dict, live_schema: tuple[str, ...]) -> None:
    """Startup gate: every column the artifact was trained on must exist
    in the live profile's column set (profile.feature_schema). Weights
    apply BY NAME, so order differences are fine; a trained column the
    live profile does not build is not — the policy would silently lose
    a signal it was trained to rely on."""
    missing = [f for f in art["feature_schema"] if f not in live_schema]
    if missing:
        raise ValueError(
            f"policy artifact was trained on columns {missing} that the "
            f"live profile does not produce (live schema: "
            f"{list(live_schema)}); refusing to route with a blinded "
            "policy")


def artifact_weight_values(art: dict) -> dict[str, np.float32]:
    """The bit-exact weight mapping (decoded from hex)."""
    return {
        name: policy.float32_from_hex(str(entry["hex"]))
        for name, entry in art["weights"].items()
    }


def to_sched_weights(art: dict):
    """Artifact -> sched Weights struct (absent columns weight 0 — the
    multiplicative no-op)."""
    return policy.weights_from_mapping(
        {k: float(v) for k, v in artifact_weight_values(art).items()})
