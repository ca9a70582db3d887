"""expert_ffn_roofline.serve (experts: `experts.llama_ffn` over K1 / K4):
the least time the expert layers' work of the traced sub-window needs
(the larger of its bytes over the card's HBM bandwidth and its FLOPs
over 989 TFLOP/s; `_work.expert_ffn`) over the device time of the
kernels the expert layer launched, in %. Moves serve_tokens_per_s."""

from portbench.metrics import _wraps, _work

WRAPS = [_wraps.EXPERTS]


def read(run):
    calls = _wraps.expert_rows(run)
    dev = _wraps.device_s(run, ["pb.experts"])
    if not calls or dev <= 0:
        return None
    bw = _work.hbm_bytes_per_s(run.device_kind)
    need = sum(_work.bound_s(*_work.expert_ffn(rows, m, h, bits), bw)
               for rows, m, h, bits in calls)
    return 100.0 * need / dev
