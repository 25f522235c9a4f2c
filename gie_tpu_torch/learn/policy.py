"""The multiplicative learned scorer (port of gie_tpu/learn/policy.py).

The learned score is a product of the normalized scorer columns raised to
trained exponents,

    total = prod_s col_s ** w_s  =  exp(sum_s w_s * log(max(col_s, EPS)))

computed in log space over the stacked [S, N, M] columns as a left fold
over the columns, elementwise like the heuristic blend (profile.blend),
so a mesh's blocks equal the whole. The reference leaves
this to XLA (no Pallas kernel), so the port runs it as plain torch ops,
inside the captured cycle on CUDA. The numpy reference pins the algebra
with an ULP bound: a fused program and numpy libm differ in the last
bits of a transcendental chain.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# Floor inside the log: columns are normalized to [0, 1] and 0.0 is a
# legitimate "worst" value; log(EPS) ~= -13.8 keeps the product finite.
EPS = np.float32(1e-6)


def multiplicative_total(stacked: torch.Tensor,
                         wvec: torch.Tensor) -> torch.Tensor:
    """exp(sum_s w_s * log(max(col_s, EPS))) over stacked f32[S, N, M]
    -> f32[N, M]."""
    logs = torch.log(torch.clamp_min(stacked, float(EPS)))
    # A left fold over the columns, as multiplicative_total_reference.
    acc = wvec[0] * logs[0]
    for s in range(1, logs.shape[0]):
        acc = acc + wvec[s] * logs[s]
    return torch.exp(acc)


def multiplicative_total_reference(stacked: np.ndarray,
                                   wvec: np.ndarray) -> np.ndarray:
    """Plain-numpy multiplicative_total: float32 intermediates, a
    left-to-right fold over the columns."""
    stacked = np.asarray(stacked, dtype=np.float32)
    wvec = np.asarray(wvec, dtype=np.float32)
    acc = (wvec[0] * np.log(np.maximum(stacked[0], EPS))).astype(np.float32)
    for s in range(1, stacked.shape[0]):
        term = wvec[s] * np.log(np.maximum(stacked[s], EPS))
        acc = (acc + term).astype(np.float32)
    return np.exp(acc).astype(np.float32)


def float32_hex(value: float) -> str:
    """Little-endian IEEE-754 float32 bytes as hex: the bitwise-stable wire
    form of a trained weight."""
    return np.array(value, dtype="<f4").tobytes().hex()


def float32_from_hex(hexed: str) -> np.float32:
    """Inverse of float32_hex."""
    raw = bytes.fromhex(hexed)
    if len(raw) != 4:
        raise ValueError(f"float32 hex must be 8 hex chars (got {hexed!r})")
    return np.frombuffer(raw, dtype="<f4")[0]


def weights_from_mapping(mapping: dict):
    """The port's sched Weights from a {column: exponent} dict. Columns
    absent from the mapping get 0.0: col**0 == 1, a no-op."""
    from gie_tpu_torch.sched.types import Weights

    fields = {f.name for f in dataclasses.fields(Weights)}
    unknown = set(mapping) - fields
    if unknown:
        raise ValueError(
            f"unknown scorer columns in policy weights: {sorted(unknown)}")
    return Weights(**{name: float(np.float32(mapping.get(name, 0.0)))
                      for name in fields})
