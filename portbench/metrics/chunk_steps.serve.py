"""chunk_steps.serve (engine: `serving.LmDecodeEngine.step_chunk`, the
program's `tutel.engine.chunk` spans): the mean number of decode steps of
the chunks in the traced sub-window that decoded. A chunk runs the steps
asked for (the cell's `chunk`), cut to the smallest remaining budget of
any live slot; each chunk pays one admission flush, one slot sweep and
one token fetch. Moves serve_tokens_per_s."""

from portbench.metrics import _spans

WRAPS = []


def read(run):
    recs = _spans.records(run)
    if recs is None:
        return None
    steps = [r.attrs.get("steps", 0)
             for r in _spans.named(recs, "tutel.engine.chunk")]
    steps = [s for s in steps if s > 0]
    return sum(steps) / len(steps) if steps else None
