"""probe_ms_per_step.train (MoE layer: the dropless capacity probe,
`MOELayer._count_needed`, the program's `tutel.moe.probe` spans): device
milliseconds a training step of the kernels the probe launched (a second
routing of the batch, its cumsum and the max of its counts), over the
traced sub-window. A part of routing_ms_per_step.train. Moves
train_tokens_per_s."""

from portbench.metrics import _spans

WRAPS = []


def read(run):
    steps = run.trace_steps
    if not steps or _spans.records(run) is None:
        return None
    dev = _spans.launched_device_s(run, "tutel.moe.probe")
    return None if dev is None else 1e3 * dev / steps
