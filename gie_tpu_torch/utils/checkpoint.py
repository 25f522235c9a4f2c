"""Checkpoint helpers: a flat dict of arrays as one `.npz` per directory
(the port's stand-in for gie_tpu/utils/checkpoint.py, which writes orbax).

The reference writes its checkpoints with orbax, a JAX library; the port
imports no JAX, so it writes the same leaves as `DIR/pytree.npz`. The two
formats differ: a reference checkpoint crosses over through the
replication digest or `install_state`, not through this file. Leaves are
materialized to host numpy before the write, and the write goes to a
temporary name renamed over the file, so a reader never sees half of it.

Restores never raise into their callers: a missing directory, an orbax
directory (no `.npz`), a truncated or otherwise unreadable file, or one
that lacks a key of the template restores as None, with a log line for
everything but the missing directory (which the reference treats the
same way, silently).
"""

from __future__ import annotations

import os
import zipfile
from typing import Optional

import numpy as np

from gie_tpu_torch.runtime.logging import get_logger

FILENAME = "pytree.npz"

log = get_logger("checkpoint")


def _host(leaf) -> np.ndarray:
    if hasattr(leaf, "detach"):          # a torch tensor, on any device
        leaf = leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_pytree(directory: str, tree: dict) -> None:
    """Write `tree` (a flat mapping of names to arrays, numpy scalars or
    tensors) to `directory`/pytree.npz, creating the directory."""
    arrays = {str(k): _host(v) for k, v in tree.items()}
    path = os.path.join(os.path.abspath(directory), FILENAME)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path + ".tmp", "wb") as f:
        np.savez(f, **arrays)
    os.replace(path + ".tmp", path)


def restore_pytree_raw(directory: str) -> Optional[dict]:
    """The checkpoint's own {name: array} dict, or None when the
    directory is missing or holds nothing this format can read."""
    base = os.path.abspath(directory)
    if not os.path.isdir(base):
        return None
    path = os.path.join(base, FILENAME)
    try:
        with np.load(path, allow_pickle=False) as saved:
            return {k: saved[k] for k in saved.files}
    except (OSError, ValueError, EOFError, zipfile.BadZipFile) as e:
        log.info("checkpoint unreadable; not restored", dir=base,
                 err=f"{type(e).__name__}: {e}")
        return None


def restore_pytree(directory: str, template: dict) -> Optional[dict]:
    """Restore into `template`'s keys, each leaf a numpy array of the
    saved values; None when the checkpoint is missing, unreadable or
    lacks a key of the template."""
    raw = restore_pytree_raw(directory)
    if raw is None:
        return None
    missing = sorted(set(template) - set(raw))
    if missing:
        log.info("checkpoint lacks keys; not restored",
                 dir=os.path.abspath(directory), missing=missing)
        return None
    return {k: raw[k] for k in template}
