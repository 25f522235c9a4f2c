"""(Copy of gie_tpu/utils/lora.py, imports rewritten to gie_tpu_torch.)

LoRA adapter-name interning.

The scheduler's dense tensors carry adapter IDs (i32); adapter names arrive
as strings from two directions — request model names (proposal 003 "model
argument") and scraped `running_lora_adapters` labels. One shared registry
keeps the mapping consistent across both so affinity matching works.
"""

from __future__ import annotations

import threading


class LoraRegistry:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._ids: dict[str, int] = {}

    def id_for(self, name: str) -> int:
        name = name.strip()
        if not name:
            return -1
        with self._lock:
            if name not in self._ids:
                self._ids[name] = len(self._ids) + 1
            return self._ids[name]

    def ids_for(self, names: list[str]) -> list[int]:
        return [self.id_for(n) for n in names if n.strip()]
