"""Per-model-server metric-name mappings.

The model-server protocol (reference docs/proposals/003-model-server-protocol/
README.md:28-42) fixes the required gauge SEMANTICS and lists each server's
concrete metric names; this module encodes that table.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class LabeledGauge:
    """A gauge identified by name + required label values. For info-style
    metrics (vllm:cache_config_info) `value_label` names the label whose
    VALUE carries the number."""

    name: str
    labels: dict[str, str] = dataclasses.field(default_factory=dict)
    value_label: Optional[str] = None

    def __hash__(self):  # labels dict excluded from default hash
        return hash((self.name, tuple(sorted(self.labels.items())), self.value_label))


@dataclasses.dataclass(frozen=True)
class ServerMapping:
    queued: LabeledGauge
    running: LabeledGauge
    kv_util: LabeledGauge
    block_size: Optional[LabeledGauge] = None
    num_blocks: Optional[LabeledGauge] = None
    lora_info: Optional[str] = None  # vllm:lora_requests_info-style gauge


VLLM = ServerMapping(
    queued=LabeledGauge("vllm:num_requests_waiting"),
    running=LabeledGauge("vllm:num_requests_running"),
    kv_util=LabeledGauge("vllm:kv_cache_usage_perc"),
    block_size=LabeledGauge("vllm:cache_config_info", value_label="block_size"),
    num_blocks=LabeledGauge("vllm:cache_config_info", value_label="num_gpu_blocks"),
    lora_info="vllm:lora_requests_info",
)

TRITON_TRTLLM = ServerMapping(
    queued=LabeledGauge(
        "nv_trt_llm_request_metrics", {"request_type": "waiting"}
    ),
    running=LabeledGauge(
        "nv_trt_llm_request_metrics", {"request_type": "scheduled"}
    ),
    kv_util=LabeledGauge(
        "nv_trt_llm_kv_cache_block_metrics", {"kv_cache_block_type": "fraction"}
    ),
    block_size=LabeledGauge(
        "nv_trt_llm_kv_cache_block_metrics", {"kv_cache_block_type": "tokens_per"}
    ),
    num_blocks=LabeledGauge(
        "nv_trt_llm_kv_cache_block_metrics", {"kv_cache_block_type": "max"}
    ),
)

TRTLLM_SERVE = ServerMapping(
    queued=LabeledGauge("trtllm_num_requests_waiting"),
    running=LabeledGauge("trtllm_num_requests_running"),
    kv_util=LabeledGauge("trtllm_kv_cache_utilization"),
    block_size=LabeledGauge("trtllm_kv_cache_tokens_per_block"),
    num_blocks=LabeledGauge("trtllm_kv_cache_max_blocks"),
)

SGLANG = ServerMapping(
    queued=LabeledGauge("sglang:num_queue_reqs"),
    running=LabeledGauge("sglang:num_running_reqs"),
    kv_util=LabeledGauge("sglang:token_usage"),
    block_size=LabeledGauge("sglang:cache_config_info", value_label="page_size"),
    num_blocks=LabeledGauge("sglang:cache_config_info", value_label="num_pages"),
    lora_info="sglang:lora_requests_info",
)

BY_NAME = {
    "vllm": VLLM,
    "triton-tensorrt-llm": TRITON_TRTLLM,
    "trtllm-serve": TRTLLM_SERVE,
    "sglang": SGLANG,
}
