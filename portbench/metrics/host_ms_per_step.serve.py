"""host_ms_per_step.serve (engine: the program's `tutel.engine.chunk`
spans, less the admission flushes they open with, `tutel.engine.admit`,
as decode_step_ms leaves them out, and less the `tutel.sync` spans in
the rest): host milliseconds a decode step in which the host does not
wait on the device (Python, launches and bookkeeping), over the chunks
of the traced sub-window. Moves serve_tokens_per_s."""

from portbench.metrics import _spans

WRAPS = []


def read(run):
    recs = _spans.records(run)
    if recs is None:
        return None
    chunks = _spans.named(recs, "tutel.engine.chunk")
    steps = sum(r.attrs.get("steps", 0) for r in chunks)
    if not steps:
        return None
    admits = _spans.within(recs, "tutel.engine.admit", "tutel.engine.chunk")
    waits = set(_spans.within(recs, "tutel.sync", "tutel.engine.chunk")) \
        - set(_spans.within(recs, "tutel.sync", "tutel.engine.admit"))
    return 1e3 * (_spans.seconds(chunks) - _spans.seconds(admits)
                  - _spans.seconds(waits)) / steps
