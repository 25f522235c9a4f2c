"""Model-server metrics layer: scrape -> the EndpointBatch a wave reads
(port of gie_tpu/metricsio)."""

from gie_tpu_torch.metricsio.store import MetricsStore

__all__ = ["MetricsStore", "ScrapeEngine"]


def __getattr__(name):
    # Lazy, as in the reference: the bare store import stays light.
    if name == "ScrapeEngine":
        from gie_tpu_torch.metricsio.engine import ScrapeEngine

        return ScrapeEngine
    raise AttributeError(name)
