"""Learned components: the TTFT/TPOT latency predictor (port of
gie_tpu/models)."""

from gie_tpu_torch.models.latency import (
    LatencyPredictor,
    LatencyPredictorConfig,
    OnlineTrainer,
    predictor_score_fn,
)

__all__ = [
    "LatencyPredictor",
    "LatencyPredictorConfig",
    "OnlineTrainer",
    "predictor_score_fn",
]
