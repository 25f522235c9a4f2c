"""Model-server stub: time-accurate vLLM queue/KV/LoRA dynamics without
accelerators (reference docs/proposals/006-scheduler/README.md:164-174
mandates exactly this for scheduler testing/benchmarking)."""

from gie_tpu_torch.simulator.vllm_stub import StubConfig, VLLMStub

__all__ = ["StubConfig", "VLLMStub"]
