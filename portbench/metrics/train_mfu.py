"""train_mfu (model, the whole step): three times the forward's matmul
FLOPs of the rows the step really computes (experts: the rows routed to
each, up to its capacity, as the traced sub-window's expert calls give
them a step; no capacity padding), times the steps of the window, over
the window times 989 TFLOP/s, in %. Moves train_tokens_per_s."""

from portbench.metrics import _wraps, _work

WRAPS = [_wraps.EXPERTS]


def read(run):
    calls = _wraps.expert_rows(run)
    steps = run.trace_steps
    if not calls or not steps:
        return None
    rows = sum(sum(r) for r, _, _, _ in calls) / steps
    fwd = _work.moe_block_forward(run.config["port"],
                                  run.rec["tokens_per_step"],
                                  expert_rows=rows)
    return 100.0 * 3.0 * fwd * run.rec["steps"] / (run.window_s
                                                    * _work.BF16_PEAK)
