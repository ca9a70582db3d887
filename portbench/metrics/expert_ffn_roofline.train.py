"""expert_ffn_roofline.train (experts: `experts.llama_ffn`, bf16 batched
products): the least time the expert layers' forward and backward work
of the traced sub-window needs (`_work.expert_ffn_train` on the rows
each expert computed) over the device time of the expert layer's
forward kernels and of its products' backward (`_MatmulF32Backward`),
in %. The SwiGLU's elementwise backward runs under generic autograd
names and is not counted. Moves train_tokens_per_s."""

from portbench.metrics import _wraps, _work

WRAPS = [_wraps.EXPERTS]


def read(run):
    calls = _wraps.expert_rows(run)
    dev = _wraps.device_s(run, ["pb.experts"]) + \
        run.trace.device_s_backward.get("_MatmulF32Backward", 0.0)
    if not calls or dev <= 0:
        return None
    bw = _work.hbm_bytes_per_s(run.device_kind)
    need = sum(_work.bound_s(*_work.expert_ffn_train(rows, m, h), bw)
               for rows, m, h, _ in calls)
    return 100.0 * need / dev
