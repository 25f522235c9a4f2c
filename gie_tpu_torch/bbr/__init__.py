"""Body-based routing (BBR): pluggable request-body processors
(copy of gie_tpu/bbr/__init__.py).

Port of reference docs/proposals/1964-pluggable-bbr-framework/README.md:
a chain of plugins sharing ONE parsed body (the OpenAI completion/chat
shape), each returning headers to set and optionally a mutated body.
"""

from gie_tpu_torch.bbr.chain import (
    BBRPlugin,
    ModelExtractorPlugin,
    ModelRewritePlugin,
    PluginChain,
    MODEL_HEADER,
)

__all__ = [
    "BBRPlugin",
    "ModelExtractorPlugin",
    "ModelRewritePlugin",
    "PluginChain",
    "MODEL_HEADER",
]
