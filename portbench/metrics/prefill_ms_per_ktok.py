"""prefill_ms_per_ktok (model: `models.transformer` prefill, through the
engine's admission flush): host milliseconds of the flushes in the traced
sub-window that prefilled prompts (each ends when the first tokens reach
the host), per thousand prompt tokens. Moves ttft_p90_ms."""

from portbench.metrics import _wraps

WRAPS = [_wraps.PREFILL]


def read(run):
    calls = [c for c in run.trace.calls.get("pb.engine.prefill", [])
             if c[2]]
    tokens = sum(c[2] for c in calls)
    if not tokens:
        return None
    return 1e3 * sum(t1 - t0 for t0, t1, _ in calls) / (tokens / 1e3)
