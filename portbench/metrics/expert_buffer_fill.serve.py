"""expert_buffer_fill.serve (MoE layer: the program's `tutel.moe.experts`
spans inside `tutel.engine.step`): the rows the decode steps of the
traced sub-window routed to the experts (top_k x rows, every slot) over
the expert buffers they filled (experts x capacity), in %. Speculative
capacity sizes the buffer; the rest of it is padding the experts skip
or compute. Moves serve_tokens_per_s."""

from portbench.metrics import _spans

WRAPS = []


def read(run):
    recs = _spans.records(run)
    if recs is None:
        return None
    calls = [r.attrs for r in _spans.within(recs, "tutel.moe.experts",
                                            "tutel.engine.step")
             if r.attrs.get("routed") is not None]
    slots = sum(a["experts"] * a["capacity"] for a in calls)
    if not slots:
        return None
    return 100.0 * sum(a["routed"] for a in calls) / slots
