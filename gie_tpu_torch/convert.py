"""Carry inputs and state between gie_tpu (JAX) and gie_tpu_torch as numpy.

Each `*_from_numpy` takes a mapping of field name -> array, or any object
with those attributes (a gie_tpu EndpointBatch, RequestBatch or Weights
qualifies: its jax arrays convert through np.asarray, and this module
imports neither JAX nor gie_tpu). Each `*_to_numpy` returns a dict of numpy
arrays in the reference's dtypes, so `gie_tpu.sched.EndpointBatch(**d)`
rebuilds the reference type. u32 columns cross as np.uint32 and live in
the port as int64 (see sched/types.py).

`state_from_numpy` accepts exactly the flat dict of gie_tpu's
Scheduler.export_state (prefix_keys, prefix_present, prefix_ages,
assumed_load, ot_v, rr, tick); `state_to_numpy` returns it.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import numpy as np
import torch

from gie_tpu_torch.sched.prefix import snapshot_table, table_from_arrays
from gie_tpu_torch.sched.types import (
    EndpointBatch,
    RequestBatch,
    SchedState,
    Weights,
)

_ENDPOINT_DTYPES = {
    "metrics": np.float32, "valid": np.bool_, "lora_active": np.int32,
    "lora_waiting": np.int32, "role": np.int32,
}
_REQUEST_DTYPES = {
    "valid": np.bool_, "lora_id": np.int32, "criticality": np.int32,
    "prompt_len": np.float32, "decode_len": np.float32,
    "chunk_hashes": np.uint32, "n_chunks": np.int32, "subset_mask": np.bool_,
}


def _get(src, name: str):
    return src[name] if isinstance(src, Mapping) else getattr(src, name)


def _tensor(a, dtype, device) -> torch.Tensor:
    a = np.array(a, dtype, copy=True)
    if dtype == np.uint32:
        a = a.astype(np.int64)
    return torch.from_numpy(a).to(device)


def _host(t: torch.Tensor, dtype) -> np.ndarray:
    return t.detach().cpu().numpy().astype(dtype)


def weights_from_numpy(src) -> Weights:
    return Weights(**{
        f.name: float(np.float32(np.asarray(_get(src, f.name))))
        for f in dataclasses.fields(Weights)})


def weights_to_numpy(w: Weights) -> dict:
    return {f.name: np.float32(getattr(w, f.name))
            for f in dataclasses.fields(Weights)}


def endpoints_from_numpy(src, *, device) -> EndpointBatch:
    return EndpointBatch(**{
        name: _tensor(_get(src, name), dt, device)
        for name, dt in _ENDPOINT_DTYPES.items()})


def endpoints_to_numpy(eps: EndpointBatch) -> dict:
    return {name: _host(getattr(eps, name), dt)
            for name, dt in _ENDPOINT_DTYPES.items()}


def requests_from_numpy(src, *, device) -> RequestBatch:
    return RequestBatch(**{
        name: _tensor(_get(src, name), dt, device)
        for name, dt in _REQUEST_DTYPES.items()})


def requests_to_numpy(reqs: RequestBatch) -> dict:
    return {name: _host(getattr(reqs, name), dt)
            for name, dt in _REQUEST_DTYPES.items()}


def state_from_numpy(arrays: Mapping, *, device) -> SchedState:
    """gie_tpu export_state dict -> SchedState on `device`. Raises
    KeyError/ValueError/TypeError on malformed input; shape coherence
    beyond the table's own is profile.check_state_shapes's job."""
    table = table_from_arrays({
        "keys": arrays["prefix_keys"],
        "present": arrays["prefix_present"],
        "ages": arrays["prefix_ages"],
    }, device=device)
    if table is None:
        raise ValueError("prefix table arrays are not a coherent packed table")

    def counter(a) -> torch.Tensor:
        a = np.asarray(a, np.uint32)
        return _tensor(a.reshape(()) if a.size == 1 else a, np.uint32, device)

    return SchedState(
        prefix=table,
        assumed_load=_tensor(arrays["assumed_load"], np.float32, device),
        rr=counter(arrays["rr"]),
        tick=counter(arrays["tick"]),
        ot_v=_tensor(arrays["ot_v"], np.float32, device),
    )


def state_to_numpy(state: SchedState) -> dict:
    """SchedState -> the flat export_state dict (uint32 table columns and
    counters, f32 load and duals)."""
    table = snapshot_table(state.prefix)
    return {
        "prefix_keys": table["keys"],
        "prefix_present": table["present"],
        "prefix_ages": table["ages"],
        "assumed_load": _host(state.assumed_load, np.float32),
        "ot_v": _host(state.ot_v, np.float32),
        "rr": _host(state.rr, np.uint32),
        "tick": _host(state.tick, np.uint32),
    }


# -- the latency predictor's params ------------------------------------------
# The reference's flax tree is {"params": {"Embed_0": {"embedding"},
# "Dense_i": {"kernel" [in, out], "bias"}}}; the port's params are the
# LatencyMLP state_dict ("Embed_0.weight", "Dense_i.weight" [out, in],
# "Dense_i.bias").

_FLAX_LEAF = {"weight": "kernel", "bias": "bias"}


def _flax_name(name: str) -> tuple[str, str]:
    module, leaf = name.split(".")
    return module, ("embedding" if module.startswith("Embed")
                    else _FLAX_LEAF[leaf])


def _port_value(module: str, arr: np.ndarray) -> np.ndarray:
    """A flax leaf in the port's layout (a Dense kernel transposed)."""
    return arr.T if module.startswith("Dense") and arr.ndim == 2 else arr


def predictor_params_to_numpy(params: Mapping) -> dict:
    """Port params (tensors or arrays) -> the reference's flax tree of f32
    numpy arrays, which `LatencyPredictor.predict` of gie_tpu takes."""
    tree: dict = {}
    for name, value in params.items():
        module, leaf = _flax_name(name)
        arr = (_host(value, np.float32) if torch.is_tensor(value)
               else np.asarray(value, np.float32))
        tree.setdefault(module, {})[leaf] = np.ascontiguousarray(
            _port_value(module, arr))
    return {"params": tree}


def predictor_params_from_numpy(tree: Mapping, *, device) -> dict:
    """The reference's flax tree (numpy or jax leaves) -> port params, f32
    tensors on `device`."""
    out = {}
    for module, leaves in tree["params"].items():
        for leaf, value in leaves.items():
            name = f"{module}.{'bias' if leaf == 'bias' else 'weight'}"
            arr = _port_value(module, np.asarray(value, np.float32))
            out[name] = torch.from_numpy(
                np.array(arr, np.float32, copy=True, order="C")).to(device)
    return out


def flatten_predictor_tree(tree: Mapping, prefix: str) -> dict:
    """A flax params tree -> {prefix + "['params']['Dense_0']['kernel']":
    array}, the key strings jax.tree_util.keystr gives its leaves, in
    jax's (sorted) leaf order."""
    flat = {}
    for top in sorted(tree):
        for module in sorted(tree[top]):
            for leaf in sorted(tree[top][module]):
                flat[f"{prefix}['{top}']['{module}']['{leaf}']"] = np.asarray(
                    tree[top][module][leaf])
    return flat


def predictor_leaves_from_flat(arrays: Mapping, prefix: str,
                               cfg) -> "dict | None":
    """Port-layout f32 host params of the MLP `cfg` (a
    LatencyPredictorConfig) read from flat keys as flatten_predictor_tree
    writes them; None when a leaf is missing or has another shape (a
    partly transplanted MLP would predict garbage). Extra keys are
    ignored."""
    from gie_tpu_torch.models.latency import param_shapes

    out = {}
    for name, shape in param_shapes(cfg).items():
        module, leaf = _flax_name(name)
        got = arrays.get(f"{prefix}['params']['{module}']['{leaf}']")
        if got is None:
            return None
        arr = _port_value(module, np.asarray(got))
        if tuple(arr.shape) != shape:
            return None
        out[name] = np.ascontiguousarray(arr, np.float32)
    return out
