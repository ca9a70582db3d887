"""ttft_p90_ms: the 90th percentile, over every request first handed
tokens in the window, of the time from its send to the return of the
`step_chunk` that handed them: its prefill and that chunk's decode steps
(host clock)."""

from portbench.harness import quantile


def read(run):
    v = quantile(run.rec["ttft_s"], 0.9)
    return None if v is None else 1e3 * v
