"""What the per-layer metrics wrap: the engine's chunk and prefill, the
experts, and the attention kernels at the model's call sites."""

ENGINE = "tutel_tpu_torch.serving:LmDecodeEngine"
MODEL = "tutel_tpu_torch.models.transformer"


def _steps(args, kwargs, out, pre):
    return max((len(v) for v in out.values()), default=0)


def _staged_tokens(args, kwargs):
    return sum(len(r.prompt) for _, r in args[0]._staged)


def _span(args, kwargs, out, pre):
    return pre


STEP_CHUNK = {"target": f"{ENGINE}.step_chunk", "range": "pb.engine.decode",
              "capture": _steps}
PREFILL = {"target": f"{ENGINE}._flush_admissions",
           "range": "pb.engine.prefill", "before": _staged_tokens,
           "capture": _span}


def _experts(args, kwargs, out, pre):
    """(rows [E, C, M] shape, a copy of the rows routed to each expert,
    weight bits or 16)."""
    _, params, x = args[:3]
    ctx = args[3] if len(args) > 3 else kwargs.get("ctx")
    counts = getattr(ctx, "dispatch_count", None)
    w1 = params["w1"]
    bits = getattr(w1, "bits", 16)
    h = w1.shape[2]
    return (tuple(x.shape), h, bits,
            None if counts is None else counts.detach().clone())


EXPERTS = {"target": "tutel_tpu_torch.experts.llama_ffn:LlamaFFNNetwork.apply",
           "range": "pb.experts", "capture": _experts}


def _decode_attn(args, kwargs, out, pre):
    q, k_cache, _, pos = args[:4]
    return (tuple(q.shape), tuple(k_cache.shape), pos.detach().clone(),
            kwargs.get("attn_len"), kwargs.get("kv_bits"))


def _prefill_attn(args, kwargs, out, pre):
    q, k_cache, _, start = args[:4]
    return (tuple(q.shape), tuple(k_cache.shape), int(start),
            kwargs.get("kv_bits"))


def _kv_write(args, kwargs, out, pre):
    _, _, pendings, _ = args[:4]
    n = 0
    for pend in pendings:
        n += sum(t.numel() * t.element_size() for t in pend["rows"])
        if pend["cols"] is not None:
            n += sum(t.numel() * t.element_size() for t in pend["cols"])
    return n


ATTENTION = [
    {"target": f"{MODEL}:decode_attn", "range": "pb.attn.decode",
     "capture": _decode_attn},
    {"target": f"{MODEL}:prefill_attn", "range": "pb.attn.prefill",
     "capture": _prefill_attn},
    {"target": f"{MODEL}:TransformerMoE._flush_kv_writes",
     "range": "pb.attn.kv_write", "capture": _kv_write}]


def expert_rows(run):
    """[(rows each expert computed, M, H, weight bits)] of each experts
    call in the traced sub-window: the rows routed to it, up to the
    buffer's capacity."""
    out = []
    for _, _, (shape, h, bits, counts) in run.trace.calls.get("pb.experts",
                                                                []):
        cap = shape[1]
        live = [] if counts is None else [min(int(c), cap)
                                          for c in counts.tolist()]
        out.append((live, shape[-1], h, bits))
    return out


def device_s(run, names):
    return sum(run.trace.device_s_by_range.get(n, 0.0) for n in names)
