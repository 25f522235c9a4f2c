"""gie-learn on the port (copy of gie_tpu/learn/): offline-trained
multiplicative scheduling policies.

- `dataset.py`  — flight-recorder dumps -> feature matrices + targets.
- `train.py`    — the seeded closed-form trainer (numpy).
- `policy.py`   — the runtime form exp(sum_s w_s * log(col_s)), slotted
  into `sched.profile.build_stages` behind ProfileConfig.scorer="learned".
- `artifact.py` — the checksummed policy artifact --policy-artifact loads.
- `judge.py`    — learned against heuristic through the port's storm twin.

The heuristic weighted-sum blend stays the default; nothing here runs
unless the operator opts in.
"""
