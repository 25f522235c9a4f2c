"""Runtime pieces the pick service uses: the clock seam (copy of
gie_tpu/runtime/clock.py) and the pick-path metrics."""
