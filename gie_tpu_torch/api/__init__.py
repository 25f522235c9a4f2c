"""The API constants the pick service reads (from gie_tpu/api)."""
