"""The port's body-based routing (gie_tpu_torch/bbr) and its seam in the
StreamingServer against the reference's, side by side on the CPU.

The same request bodies go through both packages' PluginChain and through
both StreamingServers built with a BBR chain (the model extractor alone,
the extractor with the InferenceModelRewrite plugin, and a chain with a
plugin that has no scan hook), on the legacy, fast and wire lanes: the
chain's headers, mutated body and shared parse, the serialized responses
(header mutations, body mutations) and the model each picker was handed
are equal. RoundRobinPicker picks the same endpoints in the same order.
"""

import json

import numpy as np
import pytest

from tests.test_torch_extproc import (
    PKGS,
    _body_frame,
    _datastore,
    _headers_frame,
    _mod,
    _Stream,
)

SEED = 15


def _engine(pkg: str):
    """A rewrite table with exact, generic and weighted rules."""
    mr = _mod(pkg, "api.modelrewrite")
    eng = mr.RewriteEngine(seed=SEED)
    eng.apply(mr.InferenceModelRewrite(
        name="rw-generic", pool_ref="pool",
        rules=[mr.RewriteRule(targets=[mr.TargetModel("fallback-model")])]))
    eng.apply(mr.InferenceModelRewrite(
        name="rw-exact", pool_ref="pool",
        rules=[mr.RewriteRule(matches=[mr.ModelMatch("gpt-fast")],
                              targets=[mr.TargetModel("llama-70b")])]))
    eng.apply(mr.InferenceModelRewrite(
        name="rw-split", pool_ref="pool",
        rules=[mr.RewriteRule(
            matches=[mr.ModelMatch("base")],
            targets=[mr.TargetModel("a", weight=3),
                     mr.TargetModel("b", weight=1)])]))
    return eng


class _NoScan:
    """A plugin without execute_scanned: the fast lane must parse."""

    name = "no-scan"

    def execute(self, body, parsed):
        if parsed and "prompt" in parsed:
            return {"x-prompt-chars": str(len(str(parsed["prompt"])))}, None
        return {}, None


def _chain(pkg: str, kind: str):
    bbr = _mod(pkg, "bbr")
    plugins = [bbr.ModelExtractorPlugin()]
    if kind in ("rewrite", "no-scan"):
        plugins.append(bbr.ModelRewritePlugin(_engine(pkg), pool="pool"))
    if kind == "no-scan":
        plugins.append(_NoScan())
    return bbr.PluginChain(plugins)


def _bodies() -> list:
    """Seeded request bodies: exact, generic and weighted rewrites, no
    model, a non-string model, non-JSON and an empty body."""
    rng = np.random.default_rng(SEED)
    models = ["gpt-fast", "base", "other-model", "base", "gpt-fast"]
    out = []
    for i in range(12):
        doc = {"model": models[i % len(models)],
               "prompt": "q%d " % i + "x" * int(rng.integers(1, 200))}
        if i % 3 == 0:
            doc["max_tokens"] = int(rng.integers(1, 512))
        out.append(json.dumps(doc).encode())
    out += [json.dumps({"prompt": "no model"}).encode(),
            json.dumps({"model": 7, "prompt": "n"}).encode(),
            b"\x00\x01 not json", b""]
    return out


BODIES = _bodies()


@pytest.mark.parametrize("kind", ["extract", "rewrite", "no-scan"])
def test_chain_execute_and_scan_equal_reference(kind):
    chains = [_chain(pkg, kind) for pkg in PKGS]
    assert chains[1].supports_scan == chains[0].supports_scan
    for body in BODIES:
        got = [c.execute(body) for c in chains]
        assert got[1] == got[0], body
        scans = [_mod(pkg, "extproc.fieldscan").scan(body) for pkg in PKGS]
        got = [c.execute_scanned(s) for c, s in zip(chains, scans)]
        assert got[1] == got[0], body


def _serve(pkg: str, kind: str, lane: str) -> list:
    """Every body as one stream through a StreamingServer with the BBR
    chain: (serialized responses, the model the picker saw) per stream."""
    server_mod = _mod(pkg, "extproc.server")
    seen = []

    class Capture(server_mod.RoundRobinPicker):
        def pick(self, req, candidates):
            seen.append((req.model, req.decode_tokens))
            return super().pick(req, candidates)

    srv = server_mod.StreamingServer(
        _datastore(pkg), Capture(), bbr_chain=_chain(pkg, kind),
        fast_lane=lane != "legacy")
    pb = _mod(pkg, "extproc.pb")
    out = []
    for body in BODIES:
        frames = [_headers_frame(end_of_stream=False), _body_frame(body)]
        if lane == "wire":
            session = srv.wire_session()
            sent = []
            for data in frames:
                sent += session.feed(data)
            session.close(None)
        else:
            stream = _Stream([pb.ProcessingRequest.FromString(f)
                              for f in frames])
            srv.process(stream)
            sent = [r.SerializeToString() for r in stream.sent]
        out.append(sent)
    return list(zip(out, seen))


@pytest.mark.parametrize("kind", ["extract", "rewrite", "no-scan"])
@pytest.mark.parametrize("lane", ["legacy", "fast", "wire"])
def test_server_bbr_mutations_equal_reference(lane, kind):
    ref, port = (_serve(pkg, kind, lane) for pkg in PKGS)
    assert port == ref
    # The chain's headers reached the mutation: the rewritten model name
    # where a rewrite rule fired.
    pb = _mod("gie_tpu_torch", "extproc.pb")
    headers = pb.ProcessingResponse.FromString(port[0][0][0])
    keys = {o.header.key for o in
            headers.request_headers.response.header_mutation.set_headers}
    assert "X-Gateway-Model-Name" in keys
    if kind != "extract":
        assert port[0][1][0] == "llama-70b"


def test_upstream_rewrite_header_beats_extracted_model():
    """The rewrite header wins over the chain's extracted model in both."""
    seen = {}
    for pkg in PKGS:
        server_mod = _mod(pkg, "extproc.server")
        pb = _mod(pkg, "extproc.pb")

        class Capture(server_mod.RoundRobinPicker):
            def pick(self, req, candidates, pkg=pkg):
                seen[pkg] = req.model
                return super().pick(req, candidates)

        srv = server_mod.StreamingServer(
            _datastore(pkg), Capture(), bbr_chain=_chain(pkg, "extract"))
        frames = [_headers_frame([("x-gateway-model-name-rewrite", "ft")],
                                 end_of_stream=False),
                  _body_frame(BODIES[0])]
        srv.process(_Stream([pb.ProcessingRequest.FromString(f)
                             for f in frames]))
    assert seen == {"gie_tpu": "ft", "gie_tpu_torch": "ft"}


def test_round_robin_picker_equal_reference():
    picks = []
    for pkg in PKGS:
        server_mod = _mod(pkg, "extproc.server")
        ds = _datastore(pkg)
        rr = server_mod.RoundRobinPicker()
        req = server_mod.PickRequest(headers={})
        picks.append([rr.pick(req, ds.pick_candidates()).endpoint
                      for _ in range(9)])
        with pytest.raises(server_mod.ExtProcError) as e:
            rr.pick(req, [])
        picks[-1].append(getattr(e.value.code, "name", e.value.code))
    assert picks[1] == picks[0]
    assert picks[1][-1] == "UNAVAILABLE"
