"""Multi-host launcher (counterpart: tutel_tpu/launcher/)."""
