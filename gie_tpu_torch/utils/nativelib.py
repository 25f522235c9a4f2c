"""Path resolution for the native/ fast-path libraries.

One place encodes the variant scheme: ``GIE_NATIVE_ASAN=1`` selects the
``make -C native asan`` sanitizer build (``libgie*-asan.so`` — LD_PRELOAD
libasan first; docs/ANALYSIS.md), so the whole Python parity suite can
run under ASan/UBSan. A future ``-tsan`` variant (ROADMAP item 7) slots
in here, not in every loader.
"""

from __future__ import annotations

import os

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def native_lib_path(stem: str) -> str:
    """Absolute path of ``native/lib<stem>[-asan].so`` for this tree."""
    # Value check, not presence: GIE_NATIVE_ASAN=0 must mean OFF (the
    # -asan .so fails to load without LD_PRELOADed libasan, and every
    # loader would silently fall back to the slow pure-Python path).
    asan = os.environ.get("GIE_NATIVE_ASAN", "") not in ("", "0")
    suffix = "-asan" if asan else ""
    return os.path.join(_REPO, "native", f"lib{stem}{suffix}.so")
