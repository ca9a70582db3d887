"""serve_tokens_per_s: prompt tokens prefilled plus tokens generated
inside the window, over the window (host clock)."""


def read(run):
    r = run.rec
    return (r["prompt_tokens"] + r["tokens"]) / run.window_s
