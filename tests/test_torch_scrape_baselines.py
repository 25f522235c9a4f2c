"""The port's Scraper adapter and ThreadPerEndpointScraper baseline against
gie_tpu's: from the same stub expositions each fills the same MetricsStore
rows (metric columns, LoRA residency, the freshest-series rule) as the
reference's class of the same name; detach clears a row, a re-attach at a
new URL moves the poller, and the default fetcher reads a real loopback
HTTP endpoint."""

from __future__ import annotations

import http.server
import threading
import time

import numpy as np
import pytest

from gie_tpu.metricsio import MetricsStore as RefStore
from gie_tpu.metricsio import scrape as ref_scrape
from gie_tpu.metricsio.mappings import SGLANG as REF_SGLANG
from gie_tpu.metricsio.mappings import VLLM as REF_VLLM
from gie_tpu.utils.lora import LoraRegistry as RefRegistry
from gie_tpu_torch.metricsio import MetricsStore
from gie_tpu_torch.metricsio import scrape
from gie_tpu_torch.metricsio.mappings import SGLANG, VLLM
from gie_tpu_torch.utils.lora import LoraRegistry
from tests.test_metricsio_sim import SGLANG_TEXT, VLLM_TEXT
from tests.test_scrape_engine import VLLM_TEXT_2

T = 1000.0          # both stores' clock: the METRICS_AGE column compares
URLS = ["http://127.0.1.1:8000/metrics", "http://127.0.1.2:8000/metrics",
        "http://127.0.1.3:8000/metrics"]
TEXTS = dict(zip(URLS, (VLLM_TEXT, VLLM_TEXT_2, SGLANG_TEXT)))
ADAPTERS = ("a1", "a2", "a3", "zz", "stale", "old")


def _wait_rows(store, slots, timeout=10.0) -> None:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if all(store._has_data[s] for s in slots):
            return
        time.sleep(0.005)
    raise AssertionError(f"no scrape data for slots "
                         f"{[s for s in slots if not store._has_data[s]]}")


def _rows(store, n):
    return (store._metrics[:n].copy(), store._lora_active[:n].copy(),
            store._lora_waiting[:n].copy(), store._has_data[:n].copy())


def _scrape(cls, store, registry, mappings, *, detach=None, move=None):
    """Attach the three stub endpoints, wait for their rows, optionally
    detach one slot and re-attach another at a new URL; -> the rows."""
    for name in ADAPTERS:                # pin the interning order
        registry.id_for(name)
    calls = []

    def fetch(url):
        calls.append(url)
        return TEXTS[url.replace("/moved", "")]

    sc = cls(store, lora=registry, interval_s=0.01, fetcher=fetch)
    try:
        for slot, (url, mapping) in enumerate(zip(URLS, mappings)):
            sc.attach(slot, url, mapping)
        _wait_rows(store, range(len(URLS)))
        if detach is not None:
            sc.detach(detach)
        if move is not None:
            n = len(calls)
            sc.attach(move, URLS[move] + "/moved", mappings[move])
            deadline = time.monotonic() + 10.0
            # Two polls of the new URL: the first one's row is written
            # before the poller fetches again.
            while calls[n:].count(URLS[move] + "/moved") < 2:
                assert time.monotonic() < deadline, "moved slot never polled"
                time.sleep(0.005)
            _wait_rows(store, [move])
        return _rows(store, len(URLS))
    finally:
        sc.close()


@pytest.mark.parametrize("variant", ["rows", "detach", "move"])
@pytest.mark.parametrize("name", ["Scraper", "ThreadPerEndpointScraper"])
def test_scraper_fills_the_reference_rows(name, variant):
    kw = {"rows": {}, "detach": {"detach": 1}, "move": {"move": 2}}[variant]
    want = _scrape(getattr(ref_scrape, name), RefStore(clock=lambda: T),
                   RefRegistry(), (REF_VLLM, REF_VLLM, REF_SGLANG), **kw)
    got = _scrape(getattr(scrape, name), MetricsStore(clock=lambda: T),
                  LoraRegistry(), (VLLM, VLLM, SGLANG), **kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
    metrics, active, _waiting, has = got
    assert metrics.any() and (active >= 0).any()
    assert has.tolist() == [True, variant != "detach", True]


def test_thread_per_endpoint_default_fetcher_reads_loopback_http():
    """The baseline's own urllib fetcher against a loopback HTTP server,
    side by side with the reference's: the same row."""
    body = VLLM_TEXT.encode()

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):
            pass

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}/metrics"
    try:
        rows = []
        for cls, store, reg, mapping in (
                (ref_scrape.ThreadPerEndpointScraper, RefStore(lambda: T),
                 RefRegistry(), REF_VLLM),
                (scrape.ThreadPerEndpointScraper, MetricsStore(lambda: T),
                 LoraRegistry(), VLLM)):
            for name in ADAPTERS:
                reg.id_for(name)
            sc = cls(store, lora=reg, interval_s=0.01)
            sc.attach(0, url, mapping)
            try:
                _wait_rows(store, [0])
            finally:
                sc.close()
            rows.append(_rows(store, 1))
    finally:
        srv.shutdown()
        srv.server_close()
    for g, w in zip(rows[1], rows[0]):
        assert g.tobytes() == w.tobytes()
    assert not rows[1][3].any()          # close() detached: the row cleared
    assert np.all(rows[1][0] == 0)
