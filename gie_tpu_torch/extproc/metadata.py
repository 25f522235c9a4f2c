"""(Copy of gie_tpu/extproc/metadata.py, imports rewritten to gie_tpu_torch.)

Canonical protocol keys (reference pkg/lwepp/metadata/consts.go:26-38)."""

# Outer namespace wrapping the subset filter in request metadata.
SUBSET_FILTER_NAMESPACE = "envoy.lb.subset_hint"
# Candidate-endpoints key inside the subset namespace (string or array).
SUBSET_FILTER_KEY = "x-gateway-destination-endpoint-subset"
# Outer namespace for the destination endpoint in response dynamic metadata.
DESTINATION_ENDPOINT_NAMESPACE = "envoy.lb"
# Header + metadata key carrying the picked endpoint(s).
DESTINATION_ENDPOINT_KEY = "x-gateway-destination-endpoint"
# Response-phase metadata key reporting which endpoint actually served.
DESTINATION_ENDPOINT_SERVED_KEY = "x-gateway-destination-endpoint-served"
# Disaggregated prefill/decode (beyond-reference; the reference lists
# disaggregated serving as roadmap README.md:115): with
# ProfileConfig.pd_disaggregation the destination endpoint is the DECODE
# worker and this header names the prefill worker the data plane should
# run prefill on (e.g. for a llm-d-style disaggregation sidecar).
PREFILL_ENDPOINT_KEY = "x-gateway-prefill-endpoint"
# Conformance echo header (reference Appendix B test affordances).
CONFORMANCE_TEST_RESULT_HEADER = "x-conformance-test-served-endpoint"
# Flow-control fairness ID header (proposal 1199 / flow control).
FLOW_FAIRNESS_ID_KEY = "x-gateway-inference-fairness-id"
# Request objective/criticality header (proposal 1199).
OBJECTIVE_KEY = "x-gateway-inference-objective"
# Model-name rewrite header (proposal 1816).
MODEL_NAME_REWRITE_KEY = "x-gateway-model-name-rewrite"
# Extracted-model header set by BBR (proposal 1964 default plugin).
MODEL_NAME_HEADER = "X-Gateway-Model-Name"

# Test-only steering header (reference request.go:84-97 + conformance
# utils/headers/headers.go:19-22).
# Per-request TTFT SLO in milliseconds (proposal 006's SLO dimension,
# reference docs/proposals/006-scheduler/README.md:27-36): with the latency
# predictor enabled, non-critical requests whose PREDICTED TTFT already
# misses this bound are shed with 429 instead of wasting capacity.
TTFT_SLO_MS_KEY = "x-gateway-inference-ttft-slo-ms"
# Per-request expected output length in TOKENS (proposal 006's
# output-length dimension, reference docs/proposals/006-scheduler/
# README.md:27-36). Explicit header beats the body's max_tokens /
# max_completion_tokens / max_output_tokens cap, which the EPP extracts
# from the (single, shared) BBR body parse otherwise.
DECODE_TOKENS_HINT_KEY = "x-gateway-inference-decode-tokens"

TEST_ENDPOINT_SELECTION_HEADER = "test-epp-endpoint-selection"

# Debug header set on response headers (reference response.go:57-62).
WENT_INTO_RESP_HEADERS = "x-went-into-resp-headers"
