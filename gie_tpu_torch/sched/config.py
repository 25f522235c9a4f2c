"""Declarative scheduler configuration (port of gie_tpu/sched/config.py):
one YAML document configures the batched profile; unknown keys fail
loudly."""

from __future__ import annotations

import dataclasses

import yaml

from gie_tpu_torch.sched.profile import ProfileConfig
from gie_tpu_torch.sched.types import Weights

_PLUGIN_FLAGS = {
    "prefix": "enable_prefix",
    "lora": "enable_lora",
    "saturation": "enable_saturation",
    "session": "enable_session",
}

_WEIGHT_FIELDS = {f.name for f in dataclasses.fields(Weights)}
_CONFIG_FIELDS = {f.name for f in dataclasses.fields(ProfileConfig)}


def load_scheduler_config(text: str) -> tuple[ProfileConfig, Weights]:
    """YAML -> (ProfileConfig, Weights); raises ValueError on unknown keys."""
    doc = yaml.safe_load(text) or {}
    if not isinstance(doc, dict):
        raise ValueError("scheduler config must be a YAML mapping")

    cfg_kwargs: dict = {}
    weights = Weights.default()

    for key, value in doc.items():
        if key == "plugins":
            if not isinstance(value, dict):
                raise ValueError("plugins must be a mapping of name: bool")
            for name, enabled in value.items():
                if name not in _PLUGIN_FLAGS:
                    raise ValueError(
                        f"unknown plugin {name!r}; known: {sorted(_PLUGIN_FLAGS)}")
                cfg_kwargs[_PLUGIN_FLAGS[name]] = bool(enabled)
        elif key == "weights":
            if not isinstance(value, dict):
                raise ValueError("weights must be a mapping of name: number")
            for name, w in value.items():
                if name not in _WEIGHT_FIELDS:
                    raise ValueError(
                        f"unknown weight {name!r}; known: {sorted(_WEIGHT_FIELDS)}")
                weights = weights.replace(**{name: float(w)})
        elif key == "picker":
            if value not in ("topk", "random", "sinkhorn"):
                raise ValueError(
                    f"unknown picker {value!r}; known: topk, random, sinkhorn")
            cfg_kwargs[key] = value
        elif key in _CONFIG_FIELDS:
            cfg_kwargs[key] = value
        else:
            raise ValueError(
                f"unknown scheduler config key {key!r}; known: "
                f"{sorted(_CONFIG_FIELDS | {'plugins', 'weights'})}")
    return ProfileConfig(**cfg_kwargs), weights


def load_scheduler_config_file(path: str) -> tuple[ProfileConfig, Weights]:
    with open(path) as f:
        return load_scheduler_config(f.read())


def tuned_profile() -> tuple[ProfileConfig, Weights]:
    """The production default profile: the Sinkhorn OT picker with the
    session-stickiness column (weight 8.0) and prefix weight 4.0."""
    cfg = ProfileConfig(
        picker="sinkhorn", load_decay=0.95, load_norm=8.0, queue_norm=16.0,
        sinkhorn_rounding_temp=0.05,
    )
    weights = Weights(
        queue=2.0, kv_cache=1.0, prefix=4.0, lora=1.0, assumed_load=1.5,
        latency=0.0, session=8.0,
    )
    return cfg, weights
