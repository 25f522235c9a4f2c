"""BBR plugin chain (reference proposal 1964) (copy of gie_tpu/bbr/chain.py).

The shared-parse rule (1964 README:59): the body is JSON-parsed at most once
per request into the OpenAI completion/chat shape; every plugin receives the
same read-only dict. Plugins return (headers-to-set, mutated-body-or-None);
the chain folds mutations left to right.
"""

from __future__ import annotations

import json
from typing import Optional, Protocol

from gie_tpu_torch.api.modelrewrite import RewriteEngine

# The header BBR sets for gateway routing on extracted model names
# (reference BBR default MetadataExtractor semantics). Canonical constant
# lives with the other protocol keys.
from gie_tpu_torch.extproc.metadata import MODEL_NAME_HEADER as MODEL_HEADER


class BBRPlugin(Protocol):
    name: str

    def execute(
        self, body: bytes, parsed: Optional[dict]
    ) -> tuple[dict[str, str], Optional[bytes]]: ...

    # Optional fast-lane hook: answer from the zero-parse field scan
    # (extproc/fieldscan.FieldScan) alone. Return the headers-to-set, or
    # None when this request needs the full parsed dict (e.g. a body
    # mutation applies) — the chain then falls back to execute(). A
    # plugin without this method forces the legacy lane for every
    # request.
    #
    # def execute_scanned(self, scan) -> Optional[dict[str, str]]: ...


class ModelExtractorPlugin:
    """Default plugin (1964 DefaultPluginImplementation
    'simple-model-selector'): extract `model` from the body into
    X-Gateway-Model-Name."""

    name = "simple-model-selector"

    def execute(self, body, parsed):
        if parsed and isinstance(parsed.get("model"), str):
            return {MODEL_HEADER: parsed["model"]}, None
        return {}, None

    def execute_scanned(self, scan):
        # scan.model is non-None exactly when parsed["model"] is a str.
        if scan.valid and scan.model is not None:
            return {MODEL_HEADER: scan.model}
        return {}


class ModelRewritePlugin:
    """InferenceModelRewrite enforcement: rewrite the body's model per the
    merged rule set and surface the final name in the model header + the
    rewrite header (proposal 1816 + metadata ModelNameRewriteKey)."""

    name = "model-rewrite"

    def __init__(self, engine: RewriteEngine, pool: str, namespace: str = "default"):
        self.engine = engine
        self.pool = pool
        self.namespace = namespace

    def execute(self, body, parsed):
        if not parsed or not isinstance(parsed.get("model"), str):
            return {}, None
        model = parsed["model"]
        target = self.engine.resolve(self.pool, model, self.namespace)
        if target is None or target == model:
            return {}, None
        mutated = dict(parsed)
        mutated["model"] = target
        from gie_tpu_torch.extproc import metadata as mdkeys

        return (
            {MODEL_HEADER: target, mdkeys.MODEL_NAME_REWRITE_KEY: target},
            json.dumps(mutated).encode(),
        )

    def execute_scanned(self, scan):
        if not scan.valid or scan.model is None:
            return {}
        target = self.engine.resolve(self.pool, scan.model, self.namespace)
        if target is None or target == scan.model:
            return {}  # no rule fires: nothing to mutate, scan suffices
        return None  # rewrite applies -> body mutation -> full parse


def parse_body(body: bytes) -> Optional[dict]:
    """The chain's single JSON parse (1964 README:59 shared-parse rule),
    exposed so a chain-less EPP can honor the same at-most-once contract."""
    if not body:
        return None
    try:
        obj = json.loads(body)
    except (ValueError, UnicodeDecodeError):
        return None
    return obj if isinstance(obj, dict) else None


class PluginChain:
    def __init__(self, plugins: list[BBRPlugin]):
        self.plugins = list(plugins)
        # Bound execute_scanned methods resolved once (None when any
        # plugin lacks the hook — then the fast lane is off for good and
        # execute_scanned returns None without per-request getattr).
        methods = [getattr(p, "execute_scanned", None) for p in self.plugins]
        self._scan_methods = methods if all(methods) else None

    @property
    def supports_scan(self) -> bool:
        """False when some plugin lacks the execute_scanned hook — then
        the fast lane must not bother scanning at all (the scan would be
        thrown away and the full parse would run anyway)."""
        return self._scan_methods is not None

    def execute(
        self, body: bytes
    ) -> tuple[dict[str, str], Optional[bytes], Optional[dict]]:
        """-> (headers-to-set, mutated-body-or-None, final parsed dict).

        The parsed dict (post-mutation view) rides along so downstream
        consumers — the EPP's decode-length extraction — reuse this parse
        instead of re-reading the body (the 1964 shared-parse rule applies
        to the whole request path, not just the plugins)."""
        parsed = parse_body(body)
        headers: dict[str, str] = {}
        mutated: Optional[bytes] = None
        current = parsed
        for plugin in self.plugins:
            h, m = plugin.execute(body, current)
            headers.update(h)
            if m is not None:
                mutated = m
                # `current` must always describe the CURRENT body bytes:
                # if a plugin emits an unparsable mutation, downstream
                # consumers (later plugins, decode-tokens, the transcoding
                # codec) see None — never a stale dict from a body that no
                # longer exists.
                current = parse_body(m)
        return headers, mutated, current

    def execute_scanned(self, scan) -> Optional[dict[str, str]]:
        """Fast lane (zero-parse admission): fold each plugin's
        execute_scanned over the field scan. Returns the headers-to-set,
        or None when any plugin lacks scan support or needs the full
        parse for THIS request — the caller then runs execute(), whose
        single shared parse honors the same 1964 at-most-once rule.

        Equivalence to execute(): a None from any plugin means no
        mutation ever happens on the fast lane, so every plugin saw the
        scan of the original body — exactly the parsed dict execute()
        would have fed it."""
        if self._scan_methods is None:
            return None
        headers: dict[str, str] = {}
        for fn in self._scan_methods:
            h = fn(scan)
            if h is None:
                return None
            headers.update(h)
        return headers
