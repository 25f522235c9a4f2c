"""Offline trainer: recorder dumps -> a gie-learn policy artifact (copy of
gie_tpu/learn/train.py, numpy).

The model is exactly the runtime form (policy.multiplicative_total):

    score = prod_s col_s ** w_s,   latency ~ prod_s col_s ** (-w_s)

so in log space the fit is LINEAR: regress  -log(latency_ms)  on
log(max(col, EPS)) with an intercept and an L2 ridge, solved in closed
form (float64 normal equations — CPU-fine, no iterations, nothing to
diverge), then projected to non-negative float32 exponents. Non-negative
because every column is normalized "higher is better" by construction;
a negative exponent would invert a heuristic's meaning, and the ridge
prefers 0 for columns the data cannot identify (e.g. a column the dump
never varied) — col**0 == 1, a clean no-op.

Determinism contract (pinned by tests/test_learn.py): the same dumps +
seed produce BYTE-IDENTICAL artifact text. Everything random routes
through the seed (today: only the fingerprint-keyed split salt), the
solve is order-stable float64, and the artifact's ``trained_at``
provenance derives from the DATA (max record timestamp), never the wall
clock.

CLI:  python -m gie_tpu_torch.learn.train --dump DIR_OR_FILE [...] --out PATH
"""

from __future__ import annotations

import argparse
import sys
from typing import Iterable

import numpy as np

from gie_tpu_torch.learn import artifact as artifact_mod
from gie_tpu_torch.learn import dataset as dataset_mod
from gie_tpu_torch.learn import policy

# Floor for the latency target's log (serve_latency_ms is rounded to
# 0.1 ms by the recorder, so anything below this is already clamped).
_MIN_LATENCY_MS = 1e-3


def _data_through_ts(dumps) -> float:
    """Deterministic trained-at provenance: the newest record timestamp
    in the corpus (0.0 for timestamp-free synthetic dumps)."""
    newest = 0.0
    for _, records in dumps:
        for rec in records:
            if not isinstance(rec, dict):
                continue
            ts = rec.get("ts")
            if isinstance(ts, (int, float)) and ts > newest:
                newest = float(ts)
    return round(newest, 3)


def _rmse(x: np.ndarray, w: np.ndarray, intercept: float,
          y: np.ndarray) -> float:
    if x.shape[0] == 0:
        return 0.0
    pred = x @ w + intercept
    return float(np.sqrt(np.mean((pred - y) ** 2)))


def train(
    dumps: Iterable[tuple[str, list[dict]]],
    *,
    seed: int = 0,
    eval_fraction: float = 0.25,
    l2: float = 1e-3,
    schema: tuple[str, ...] = dataset_mod.DEFAULT_FEATURES,
) -> dict:
    """Build the dataset, fit the multiplicative exponents, return a
    finalized (checksummed) policy artifact dict."""
    dumps = list(dumps)
    ds = dataset_mod.build_dataset(dumps, schema=schema)
    if len(ds) == 0:
        raise ValueError(
            f"no trainable rows in {len(dumps)} dump(s) "
            f"(skipped: {ds.skipped or '{}'})")
    train_rows, eval_rows = dataset_mod.split_by_fingerprint(
        ds, eval_fraction=eval_fraction, seed=seed)
    if train_rows.size == 0:
        raise ValueError(
            "fingerprint split left zero training rows — lower "
            "eval_fraction or add dumps")

    logx = np.log(np.maximum(
        ds.features.astype(np.float64), float(policy.EPS)))
    y = -np.log(np.maximum(
        ds.latency_ms.astype(np.float64), _MIN_LATENCY_MS))
    xt, yt = logx[train_rows], y[train_rows]
    n_feat = xt.shape[1]
    a = np.concatenate([xt, np.ones((xt.shape[0], 1))], axis=1)
    # Ridge on the exponents only — the intercept is unpenalized (it
    # cancels in ranking; it exists so the exponents fit slope, not
    # offset).
    reg = float(l2) * np.diag(
        np.concatenate([np.ones(n_feat), np.zeros(1)]))
    beta = np.linalg.solve(a.T @ a + reg, a.T @ y[train_rows])
    raw_w, intercept = beta[:n_feat], float(beta[n_feat])
    w32 = np.maximum(raw_w, 0.0).astype(np.float32)

    weights = {name: float(w32[i]) for i, name in enumerate(ds.schema)}
    eval_groups = sorted(
        {ds.fingerprints[int(g)] for g in ds.group[eval_rows]})
    provenance = {
        # The trainer as the reference names it: for the same dumps and
        # seed the port writes the reference's artifact byte for byte.
        "trainer": "gie_tpu.learn.train/closed-form-ridge",
        "seed": int(seed),
        "eval_fraction": float(eval_fraction),
        "l2": float(l2),
        "trained_at": _data_through_ts(dumps),
        "fingerprints": list(ds.fingerprints),
        "eval_fingerprints": eval_groups,
        "n_rows": int(len(ds)),
        "n_train": int(train_rows.size),
        "n_eval": int(eval_rows.size),
        "skipped": dict(sorted(ds.skipped.items())),
        "intercept": round(intercept, 9),
        "rmse_train": round(
            _rmse(xt, raw_w, intercept, yt), 9),
        "rmse_eval": round(
            _rmse(logx[eval_rows], raw_w, intercept, y[eval_rows]), 9),
    }
    return artifact_mod.build_artifact(weights, ds.schema, provenance)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m gie_tpu_torch.learn.train",
        description="Train a multiplicative scheduling policy from "
                    "flight-recorder dumps.")
    parser.add_argument("--dump", action="append", required=True,
                        metavar="PATH",
                        help="dump file or directory of *.json dumps "
                             "(repeatable)")
    parser.add_argument("--out", required=True, metavar="PATH",
                        help="artifact output path")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--eval-fraction", type=float, default=0.25)
    parser.add_argument("--l2", type=float, default=1e-3)
    args = parser.parse_args(argv)

    dumps = dataset_mod.load_dumps(args.dump)
    art = train(dumps, seed=args.seed,
                eval_fraction=args.eval_fraction, l2=args.l2)
    with open(args.out, "w") as f:
        f.write(artifact_mod.dumps_artifact(art))
    prov = art["provenance"]
    print(f"wrote {args.out}: {art['checksum']} "
          f"(rows train={prov['n_train']} eval={prov['n_eval']}, "
          f"rmse train={prov['rmse_train']} eval={prov['rmse_eval']})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
