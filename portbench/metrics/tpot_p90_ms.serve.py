"""tpot_p90_ms.serve (engine, per layer; moves serve_tokens_per_s): the
90th percentile, over every request that received tokens in the window
after its first delivery there, of its time per output token within the
window: (last delivery - first delivery) / the tokens delivered after
the first (host clock; deliveries are the returns of `step_chunk`)."""

from portbench.harness import quantile


def read(run):
    v = quantile(run.rec["tpot_s"], 0.9)
    return None if v is None else 1e3 * v
