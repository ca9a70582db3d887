"""device_idle.train (device): the share of the traced sub-window in
which no kernel, copy or set ran on the card, in %. Moves
train_tokens_per_s."""

WRAPS = []


def read(run):
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
