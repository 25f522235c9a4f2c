"""Model-server metrics sink: scraped rows -> the EndpointBatch a wave reads."""

from gie_tpu_torch.metricsio.store import MetricsStore

__all__ = ["MetricsStore"]
