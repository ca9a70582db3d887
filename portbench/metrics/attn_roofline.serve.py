"""attn_roofline.serve (attention: `ops.decode_attn` K6 and K7 at the
model's call sites, the step's cache write `ops.kv_write` K8): the least
time their work in the traced sub-window needs (`_work.decode_attn`,
`_work.prefill_attn`, the bytes K8 writes) over the device time of what
they launched, in %. A decode row reads its positions up to the step's
read window. Moves serve_tokens_per_s."""

from portbench.metrics import _wraps, _work

WRAPS = _wraps.ATTENTION


def read(run):
    calls = run.trace.calls
    bw = _work.hbm_bytes_per_s(run.device_kind)
    need = 0.0
    for _, _, (q, cache, pos, attn_len, bits) in calls.get(
            "pb.attn.decode", []):
        b, nh, hd = q
        kvh = cache[2] // (hd if bits == 8 else hd // 2)
        window = attn_len or cache[1]
        lengths = [min(int(p) + 1, window) for p in pos.tolist()]
        need += _work.bound_s(*_work.decode_attn(lengths, nh, kvh, hd,
                                                 bits), bw)
    for _, _, (q, cache, start, bits) in calls.get("pb.attn.prefill", []):
        b, tc, nh, hd = q
        kvh = cache[2] // (hd if bits == 8 else hd // 2)
        need += _work.bound_s(*_work.prefill_attn(b, tc, start, nh, kvh,
                                                  hd, bits), bw)
    for _, _, moved in calls.get("pb.attn.kv_write", []):
        need += _work.bound_s(0.0, moved, bw)
    dev = _wraps.device_s(run, ["pb.attn.decode", "pb.attn.prefill",
                                "pb.attn.kv_write"])
    if need <= 0 or dev <= 0:
        return None
    return 100.0 * need / dev
