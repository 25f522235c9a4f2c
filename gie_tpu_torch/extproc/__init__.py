"""The pick-facing half of the ext-proc layer: protocol keys (copy of
gie_tpu/extproc/metadata.py) and the types a picker takes and returns.
The gRPC transport comes with its own slice of the port."""
