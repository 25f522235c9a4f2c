"""Resilience pieces the pick service uses (copies from gie_tpu/resilience):
deadline propagation, seeded fault injection, and the sliding windows the
fairness ledgers count over. The breaker board and the degradation ladder
come with the resilience slice of the port (ROADMAP.md, Queue 1)."""
