"""train_tokens_per_s: tokens of every step that ended in the window,
each ending in torch.cuda.synchronize(), over the window (host clock)."""


def read(run):
    return run.rec["tokens"] / run.window_s
