"""Layer implementations (counterpart: tutel_tpu/impls/)."""
