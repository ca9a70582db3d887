"""Example programs of the port (counterpart: tutel_tpu/examples)."""
