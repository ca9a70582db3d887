"""decode_step_ms (engine: `serving.LmDecodeEngine.step_chunk`): host
milliseconds a decode step, over the chunks of the traced sub-window
(each chunk ends in the fetch of its tokens, so its span holds the
device's work), less the admission flushes (the prefills) that open
them. Moves serve_tokens_per_s."""

from portbench.metrics import _wraps

WRAPS = [_wraps.STEP_CHUNK, _wraps.PREFILL]


def read(run):
    calls = run.trace.calls.get("pb.engine.decode", [])
    flushes = run.trace.calls.get("pb.engine.prefill", [])
    steps = sum(c[2] for c in calls)
    if not steps:
        return None
    span = sum(t1 - t0 for t0, t1, _ in calls)
    inner = sum(f1 - f0 for f0, f1, _ in flushes
                if any(t0 <= f0 and f1 <= t1 for t0, t1, _ in calls))
    return 1e3 * (span - inner) / steps
