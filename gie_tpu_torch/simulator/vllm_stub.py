"""VLLMStub: deterministic vLLM-dynamics emulator (copy of
gie_tpu/simulator/vllm_stub.py; its KV-event sink comes with the KV-events
slice of the port).

Implements the "model server stub" the scheduler proposal requires for
benchmarks (reference docs/proposals/006-scheduler/README.md:164-174:
"time-accurate and configurable ratio emulation" of batching latency, no
accelerators): continuous batching with a running-slot cap, KV-block
accounting, automatic prefix caching (chunk-hash LRU, discounting prefill),
dynamic LoRA loading with max_lora queueing, and a Prometheus /metrics text
in vLLM's metric names (proposal 003 table) so the real scraper consumes it.

The stub advances on an explicit clock (`step(dt)`) so benchmark runs are
reproducible; TTFT/TPOT per completed request feed goodput metrics and the
latency predictor's training signal.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict, deque
from typing import Optional

from gie_tpu_torch.sched import constants as C
from gie_tpu_torch.sched.hashing import chunk_hashes
from gie_tpu_torch.sched.kvevents import BLOCK_REMOVED, BLOCK_STORED


@dataclasses.dataclass(frozen=True)
class StubConfig:
    max_running: int = 8            # continuous-batch slots
    num_kv_blocks: int = 2048
    block_tokens: int = 16
    prefill_tokens_per_s: float = 8000.0
    decode_tokens_per_s: float = 60.0   # per running request
    bytes_per_token: float = 4.0
    prefix_cache_chunks: int = 4096
    max_lora: int = 4
    lora_load_s: float = 0.5        # adapter cold-load penalty
    # Serving role for disaggregated prefill/decode fleets
    # ("both" | "prefill" | "decode"); maps to the
    # inference.networking.k8s.io/role pod label in a real cluster.
    role: str = "both"
    # Prefill/decode interference under continuous batching: while any
    # running request is still prefilling, decode token generation on this
    # pod runs at (1 - decode_interference) of its rate — the prefill-
    # priority stall that motivates disaggregated serving (decode-phase
    # latency spikes whenever a long prompt enters the batch). 0.0 (off)
    # preserves the classic independent-progress model.
    decode_interference: float = 0.0


@dataclasses.dataclass
class _Req:
    rid: int
    prompt_tokens: float
    decode_tokens: float
    lora: Optional[str]
    chunks: list[int]
    submitted_at: float = 0.0
    started_at: float = -1.0
    prefill_left_s: float = 0.0
    decode_left_tokens: float = 0.0
    first_token_at: float = -1.0
    hit_fraction: float = 0.0
    # Disaggregated decode job: KV arrived via transfer — no prefill work,
    # but the prompt's KV blocks are still held on this worker.
    prefill_done: bool = False


@dataclasses.dataclass
class Completion:
    rid: int
    ttft_s: float
    tpot_s: float
    queue_s: float
    hit_fraction: float
    output_tokens: float
    prompt_bytes: float = 0.0


class VLLMStub:
    def __init__(self, cfg: StubConfig = StubConfig(), name: str = "stub-0"):
        self.cfg = cfg
        self.name = name
        # KV-event publication (set post-construction by the harness):
        # callable accepting kvevents-shaped dicts, and the endpoint
        # identity events carry.
        self.event_sink = None
        self.hostport = name
        self.clock = 0.0
        self._next_id = 0
        self.queue: deque[_Req] = deque()
        self.running: list[_Req] = []
        self.completed: list[Completion] = []
        # chunk-hash -> last-use clock (LRU via OrderedDict)
        self._prefix: OrderedDict[int, float] = OrderedDict()
        self._loras: OrderedDict[str, float] = OrderedDict()  # resident
        self._lora_waiting: list[str] = []
        self._lora_info_ts = 0.0

    # ------------------------------------------------------------------ #

    def submit(
        self,
        prompt: bytes,
        decode_tokens: float = 128.0,
        lora: Optional[str] = None,
        prefill_done: bool = False,
    ) -> int:
        rid = self._next_id
        self._next_id += 1
        # Hash the ENTIRE prompt at a fixed 64-byte granularity (the stub
        # models the real server's block cache — independent of whatever
        # chunk size the scheduler uses for its approximate view), so
        # hit_fraction accounts for every byte of prefill it discounts.
        hashes, n = chunk_hashes(
            prompt,
            chunk_bytes=64,
            max_chunks=max(len(prompt) // 64 + 1, 1),
        )
        req = _Req(
            rid=rid,
            prompt_tokens=len(prompt) / self.cfg.bytes_per_token,
            decode_tokens=decode_tokens,
            lora=lora,
            chunks=[int(h) for h in hashes[:n]],
            submitted_at=self.clock,
            prefill_done=prefill_done,
        )
        self.queue.append(req)
        return rid

    def step(self, dt: float) -> list[Completion]:
        """Advance the clock, admitting and progressing requests. Returns
        completions finishing within this step."""
        end = self.clock + dt
        # Idle fast path: with nothing queued or running, sub-ticking is
        # pure clock arithmetic — skip straight to the end. A 2-hour
        # compressed storm (docs/STORM.md "virtual clock") steps every
        # stub through the whole night; without this the diurnal valley
        # costs the same CPU as the peak.
        if not self.queue and not self.running:
            self.clock = end
            return []
        # Fixed sub-tick for determinism.
        tick = 0.005
        while self.clock < end - 1e-12:
            sub = min(tick, end - self.clock)
            self._admit()
            self._progress(sub)
            self.clock += sub
        done = self.completed
        self.completed = []
        return done

    # ------------------------------------------------------------------ #

    def _kv_blocks_used(self) -> float:
        used = 0.0
        for r in self.running:
            generated = r.decode_tokens - r.decode_left_tokens
            used += (r.prompt_tokens + generated) / self.cfg.block_tokens
        return used

    def kv_utilization(self) -> float:
        return min(self._kv_blocks_used() / self.cfg.num_kv_blocks, 1.0)

    def _prefix_hit(self, req: _Req) -> float:
        matched = 0
        for h in req.chunks:
            if h in self._prefix:
                matched += 1
            else:
                break
        return matched / len(req.chunks) if req.chunks else 0.0

    def _prefix_insert(self, req: _Req) -> None:
        for h in req.chunks:
            if h in self._prefix:
                self._prefix.move_to_end(h)
            self._prefix[h] = self.clock
        evicted = []
        while len(self._prefix) > self.cfg.prefix_cache_chunks:
            evicted.append(self._prefix.popitem(last=False)[0])
        # KV-cache event publication: the stub's LRU uses the same chunk-
        # hash chain the scheduler keys its index by, so stored and evicted
        # hashes translate directly. Only the first MAX_CHUNKS matter to
        # the index (requests carry at most that many).
        sink = getattr(self, "event_sink", None)
        if sink is not None:
            sink({"type": BLOCK_STORED, "endpoint": self.hostport,
                  "hashes": req.chunks[: C.MAX_CHUNKS]})
            if evicted:
                sink({"type": BLOCK_REMOVED, "endpoint": self.hostport,
                      "hashes": evicted})

    def _lora_ready(self, req: _Req) -> bool:
        """Adapter residency: resident -> ready; room -> cold load penalty
        applied to prefill; full -> request waits in queue."""
        if req.lora is None:
            return True
        if req.lora in self._loras:
            self._loras.move_to_end(req.lora)
            return True
        active = {r.lora for r in self.running if r.lora}
        evictable = [a for a in self._loras if a not in active]
        if len(self._loras) < self.cfg.max_lora:
            self._loras[req.lora] = self.clock
            self._lora_info_ts = self.clock
            req.prefill_left_s += self.cfg.lora_load_s
            return True
        if evictable:
            self._loras.pop(evictable[0])
            self._loras[req.lora] = self.clock
            self._lora_info_ts = self.clock
            req.prefill_left_s += self.cfg.lora_load_s
            return True
        if req.lora not in self._lora_waiting:
            self._lora_waiting.append(req.lora)
            self._lora_info_ts = self.clock
        return False

    def _admit(self) -> None:
        while self.queue and len(self.running) < self.cfg.max_running:
            req = self.queue[0]
            need_blocks = (
                req.prompt_tokens + req.decode_tokens
            ) / self.cfg.block_tokens
            if self._kv_blocks_used() + need_blocks > self.cfg.num_kv_blocks:
                break
            if not self._lora_ready(req):
                break
            self.queue.popleft()
            if req.lora in self._lora_waiting:
                self._lora_waiting.remove(req.lora)
                self._lora_info_ts = self.clock
            if req.prefill_done:
                # KV transferred in: no prompt prefill work (any accrued
                # LoRA cold-load penalty in prefill_left_s stands — the
                # adapter must be resident on the decode worker too); the
                # local prefix cache is untouched (this worker never ran
                # the prompt).
                req.hit_fraction = 1.0
            else:
                req.hit_fraction = self._prefix_hit(req)
                effective_prompt = req.prompt_tokens * (1.0 - req.hit_fraction)
                req.prefill_left_s += (
                    effective_prompt / self.cfg.prefill_tokens_per_s)
                self._prefix_insert(req)
            req.decode_left_tokens = req.decode_tokens
            req.started_at = self.clock
            self.running.append(req)

    def _progress(self, dt: float) -> None:
        finished = []
        any_prefill = any(r.prefill_left_s > 0 for r in self.running)
        decode_rate = self.cfg.decode_tokens_per_s * (
            1.0 - self.cfg.decode_interference if any_prefill else 1.0
        )
        for r in self.running:
            if r.prefill_left_s > 0:
                r.prefill_left_s -= dt
                if r.prefill_left_s <= 0:
                    r.first_token_at = self.clock + dt + r.prefill_left_s
                continue
            if r.first_token_at < 0:
                r.first_token_at = self.clock
            r.decode_left_tokens -= dt * decode_rate
            if r.decode_left_tokens <= 0:
                finished.append(r)
        for r in finished:
            self.running.remove(r)
            ttft = r.first_token_at - r.submitted_at
            decode_time = (self.clock + dt) - r.first_token_at
            tpot = decode_time / max(r.decode_tokens, 1.0)
            self.completed.append(
                Completion(
                    rid=r.rid,
                    ttft_s=max(ttft, 0.0),
                    tpot_s=max(tpot, 0.0),
                    queue_s=max(r.started_at - r.submitted_at, 0.0),
                    hit_fraction=r.hit_fraction,
                    output_tokens=r.decode_tokens,
                    prompt_bytes=r.prompt_tokens * self.cfg.bytes_per_token,
                )
            )

    # ------------------------------------------------------------------ #

    def metrics_text(self) -> str:
        """Prometheus exposition in vLLM's metric names (proposal 003)."""
        running_loras = ",".join(self._loras.keys())
        waiting_loras = ",".join(self._lora_waiting)
        lines = [
            "# TYPE vllm:num_requests_waiting gauge",
            f"vllm:num_requests_waiting {len(self.queue)}",
            "# TYPE vllm:num_requests_running gauge",
            f"vllm:num_requests_running {len(self.running)}",
            "# TYPE vllm:kv_cache_usage_perc gauge",
            f"vllm:kv_cache_usage_perc {self.kv_utilization():.6f}",
            "# TYPE vllm:cache_config_info gauge",
            f'vllm:cache_config_info{{block_size="{self.cfg.block_tokens}",'
            f'num_gpu_blocks="{self.cfg.num_kv_blocks}"}} 1',
            "# TYPE vllm:lora_requests_info gauge",
            f'vllm:lora_requests_info{{max_lora="{self.cfg.max_lora}",'
            f'running_lora_adapters="{running_loras}",'
            f'waiting_lora_adapters="{waiting_loras}"}} '
            f"{self._lora_info_ts:.3f}",
        ]
        return "\n".join(lines) + "\n"
