"""Prometheus scrape parsing (port of gie_tpu/metricsio/scrape.py).

The metric semantics of proposal 003, read by the multiplexed keep-alive
``ScrapeEngine`` (metricsio/engine.py). The reference parses a scrape with
prometheus_client's parser when the native scanner is not built; the port
does not depend on prometheus_client, so its pure-Python path runs the
exposition-line parser below over every sample line. ``Scraper`` is a thin
adapter over the engine that keeps the legacy attach/detach/close surface,
and ``ThreadPerEndpointScraper`` the one-thread-one-connection poller, the
engine's parity and benchmark baseline; the runner builds the engine
directly.
"""

from __future__ import annotations

import re
import threading
import urllib.request
from typing import Callable, Optional, Union

from gie_tpu_torch.metricsio.mappings import LabeledGauge, ServerMapping
from gie_tpu_torch.metricsio.store import MetricsStore
from gie_tpu_torch.runtime.clock import MONOTONIC
from gie_tpu_torch.sched.constants import Metric
from gie_tpu_torch.utils.lora import LoraRegistry


def _match(sample, gauge: LabeledGauge) -> bool:
    return all(sample.labels.get(k) == v for k, v in gauge.labels.items())


# Fallback registry for callers that don't inject one: module-level so ids
# stay stable within the process (a per-call registry would reassign ids on
# every scrape and silently break affinity matching).
_DEFAULT_REGISTRY = LoraRegistry()


def wanted_columns(
    mapping: ServerMapping,
) -> list[tuple[int, LabeledGauge]]:
    """The (Metric column, gauge) table one server mapping scrapes —
    shared by the pure-Python loop and the native scanner's query spec so
    the two paths cannot desynchronize."""
    wanted: list[tuple[int, LabeledGauge]] = [
        (Metric.QUEUE_DEPTH, mapping.queued),
        (Metric.RUNNING_REQUESTS, mapping.running),
        (Metric.KV_CACHE_UTIL, mapping.kv_util),
    ]
    if mapping.block_size is not None:
        wanted.append((Metric.BLOCK_SIZE, mapping.block_size))
    if mapping.num_blocks is not None:
        wanted.append((Metric.NUM_BLOCKS, mapping.num_blocks))
    return wanted


def parse_scrape(
    text: Union[str, bytes],
    mapping: ServerMapping,
    lora: Optional[LoraRegistry] = None,
    use_native: bool = True,
) -> tuple[dict[int, float], list[int], list[int]]:
    """Prometheus exposition text -> (metric columns, active/waiting LoRA ids).

    LoRA residency follows the vllm:lora_requests_info contract (proposal
    003:43-57): gauge VALUE is a last-updated timestamp — when several series
    exist, the freshest wins — and the adapter lists ride in the
    running_lora_adapters / waiting_lora_adapters labels.

    When native/libgiepromparse.so is built, a one-pass C++ scanner pulls
    the mapped gauges and the LoRA-info sample lines (this loop is the
    metrics-in hot path: one scrape per endpoint per 50 ms, tens of KB of
    irrelevant families each); only those few lines go through the Python
    parser. Semantics are identical for well-formed expositions — parity is
    pinned in tests/test_promparse_native.py; pass use_native=False to
    force the pure-Python path. Accepts bytes (the fetcher's raw payload)
    or str.
    """
    if use_native:
        from gie_tpu_torch.metricsio import native

        extracted = native.extract(text, mapping)
        if extracted is not None:
            out, lora_lines = extracted
            lora_active, lora_waiting = _apply_lora_lines(
                "\n".join(lora_lines), lora, out)
            return out, lora_active, lora_waiting

    if isinstance(text, bytes):
        text = text.decode("utf-8", "replace")
    out: dict[int, float] = {}
    wanted = wanted_columns(mapping)
    lora_samples = []
    lora_names = (
        {mapping.lora_info, mapping.lora_info.replace(":", "_")}
        if mapping.lora_info else set()
    )
    for sample in parse_sample_lines(text):
        for col, gauge in wanted:
            if sample.name != gauge.name or not _match(sample, gauge):
                continue
            if gauge.value_label is not None:
                raw = sample.labels.get(gauge.value_label)
                if raw is not None:
                    try:
                        out[col] = float(raw)
                    except ValueError:
                        pass
            else:
                out[col] = float(sample.value)
        if sample.name in lora_names:
            lora_samples.append(sample)
    lora_active, lora_waiting = _apply_lora_samples(lora_samples, lora, out)
    return out, lora_active, lora_waiting


def _apply_lora_samples(
    samples, lora: Optional[LoraRegistry], out: dict[int, float]
) -> tuple[list[int], list[int]]:
    """Freshest-series LoRA rule (003:43-57) — ONE implementation shared by
    both parse paths."""
    lora_active: list[int] = []
    lora_waiting: list[int] = []
    best_lora_ts = float("-inf")
    for sample in samples:
        if sample.value < best_lora_ts:
            continue
        best_lora_ts = sample.value
        out[Metric.MAX_LORA] = float(sample.labels.get("max_lora", "0") or 0)
        reg = lora if lora is not None else _DEFAULT_REGISTRY
        lora_active = reg.ids_for(
            sample.labels.get("running_lora_adapters", "").split(","))
        lora_waiting = reg.ids_for(
            sample.labels.get("waiting_lora_adapters", "").split(","))
        out[Metric.WAITING_LORA] = float(len(lora_waiting))
    return lora_active, lora_waiting


class _Sample:
    """One exposition sample: name, labels and value (the fields of
    prometheus_client's Sample that the parse rules read)."""

    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: dict, value: float):
        self.name = name
        self.labels = labels
        self.value = value


_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)\s*=\s*"((?:[^"\\]|\\.)*)"')
_UNESCAPE_RE = re.compile(r"\\(.)")


def _unescape_label(raw: str) -> str:
    # Prometheus exposition label-value escapes: \\ -> \, \" -> ", \n.
    return _UNESCAPE_RE.sub(
        lambda m: "\n" if m.group(1) == "n" else m.group(1), raw)


def parse_sample_lines(text: str) -> list[_Sample]:
    """Exposition-line parser (`name{labels} value [ts]`; comments and
    blank lines skipped, malformed lines dropped). The reference runs it on
    the handful of lines its native scanner hands back; the port also runs
    it on whole scrapes when the scanner is not built, and on its own
    /metrics exposition in tests and chip_smoke.py."""
    samples: list[_Sample] = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        brace = line.find("{")
        if brace >= 0:
            end = line.rfind("}")
            if end < brace:
                continue
            name = line[:brace].strip()
            labels = {
                m.group(1): _unescape_label(m.group(2))
                for m in _LABEL_RE.finditer(line[brace + 1:end])
            }
            rest = line[end + 1:].split()
        else:
            parts = line.split()
            name, labels, rest = parts[0], {}, parts[1:]
        if not rest:
            continue
        try:
            value = float(rest[0])
        except ValueError:
            continue
        samples.append(_Sample(name, labels, value))
    return samples


def _apply_lora_lines(
    lora_text: str,
    lora: Optional[LoraRegistry],
    out: dict[int, float],
) -> tuple[list[int], list[int]]:
    """Native fast path: parse just the lora-info sample lines, then run
    the same shared rule."""
    if not lora_text.strip():
        return [], []
    return _apply_lora_samples(
        parse_sample_lines(lora_text), lora, out)


# Fetchers may return bytes (preferred: the native scanner consumes the
# raw payload without a decode/encode round-trip) or str.
Fetcher = Callable[[str], Union[str, bytes]]


def _http_fetch(url: str) -> bytes:
    with urllib.request.urlopen(url, timeout=2.0) as resp:  # noqa: S310
        return resp.read()


class Scraper:
    """Legacy-API adapter over the multiplexed ScrapeEngine.

    ``attach(slot, url, mapping)`` / ``detach(slot)`` / ``close()`` keep
    their historical meaning (detach clears the slot's row), but no call
    ever spawns a per-endpoint thread or joins one: the engine's fixed
    worker-shard pool does all polling. Call sites that want the engine's
    knobs (worker count, backoff ceiling) should construct ScrapeEngine
    directly, as the runner does."""

    def __init__(
        self,
        store: MetricsStore,
        lora: Optional[LoraRegistry] = None,
        interval_s: float = 0.05,
        fetcher: Optional[Fetcher] = None,
        workers: Optional[int] = None,
    ):
        from gie_tpu_torch.metricsio.engine import ScrapeEngine

        self.store = store
        self.interval_s = interval_s
        self._engine = ScrapeEngine(
            store, lora=lora, interval_s=interval_s, fetcher=fetcher,
            workers=workers)
        self.lora = self._engine.lora

    def attach(self, slot: int, url: str, mapping: ServerMapping) -> None:
        self._engine.attach(slot, url, mapping)

    def detach(self, slot: int) -> None:
        self._engine.detach(slot)

    def close(self) -> None:
        self._engine.close()


class ThreadPerEndpointScraper:
    """The seed's per-endpoint fast-poll loop: one poller thread and one
    fresh ``urllib`` connection per endpoint per tick.

    Kept (unchanged in behavior) as the comparison baseline for
    bench_scrape.py and the engine parity tests; production call sites
    use the ScrapeEngine. The reference runs one goroutine per endpoint
    with a configurable interval (1023 README:59-60); 50 ms default
    matches its fast-poll guidance.
    """

    def __init__(
        self,
        store: MetricsStore,
        lora: Optional[LoraRegistry] = None,
        interval_s: float = 0.05,
        fetcher: Fetcher = _http_fetch,
    ):
        self.store = store
        self.lora = lora or LoraRegistry()
        self.interval_s = interval_s
        self.fetcher = fetcher
        self._stops: dict[int, threading.Event] = {}
        self._threads: dict[int, threading.Thread] = {}
        self._urls: dict[int, str] = {}
        self._lock = threading.Lock()

    def attach(self, slot: int, url: str, mapping: ServerMapping) -> None:
        with self._lock:
            if self._urls.get(slot) == url:
                return
            already = slot in self._threads
        if already:
            # Endpoint re-bound (port renumber / pod IP change): restart the
            # poller at the new URL instead of polling the dead one forever.
            self.detach(slot)
        with self._lock:
            if self._urls.get(slot) == url:
                return
            stop = threading.Event()
            t = threading.Thread(
                target=self._poll, args=(slot, url, mapping, stop), daemon=True
            )
            self._stops[slot] = stop
            self._threads[slot] = t
            self._urls[slot] = url
            t.start()

    def detach(self, slot: int) -> None:
        with self._lock:
            stop = self._stops.pop(slot, None)
            thread = self._threads.pop(slot, None)
            self._urls.pop(slot, None)
        if stop is not None:
            stop.set()
        if thread is not None:
            thread.join(timeout=2)
        self.store.remove(slot)

    def close(self) -> None:
        for slot in list(self._threads):
            self.detach(slot)

    def _poll(
        self, slot: int, url: str, mapping: ServerMapping, stop: threading.Event
    ) -> None:
        while not stop.is_set():
            started = MONOTONIC.now()
            try:
                text = self.fetcher(url)
                metrics, active, waiting = parse_scrape(text, mapping, self.lora)
                if metrics:
                    self.store.update(
                        slot, metrics, lora_active=active, lora_waiting=waiting
                    )
            except Exception:
                # Unreachable endpoint: leave the last row; staleness shows
                # up via METRICS_AGE_S and the endpoint stays routable
                # (reference keeps stale metrics rather than evicting).
                pass
            elapsed = MONOTONIC.now() - started
            stop.wait(max(self.interval_s - elapsed, 0.001))
