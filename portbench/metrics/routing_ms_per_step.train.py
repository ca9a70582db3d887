"""routing_ms_per_step.train (MoE layer: `gates.top` and
`ops.routing.extract_critical` through `MOELayer._routing`, also the
dropless capacity probe's, and `ops.dispatch` fast_encode / fast_decode
with their backward): device milliseconds a training step, over the
traced sub-window. The router's own backward (a softmax and an [S, M] x
[M, E] product) runs under generic autograd names and is not counted.
Moves train_tokens_per_s."""

from portbench.metrics import _wraps

LAYER = "tutel_tpu_torch.impls.moe_layer:MOELayer"
DISPATCH = "tutel_tpu_torch.ops.dispatch"
WRAPS = [{"target": f"{LAYER}._routing", "range": "pb.moe.route"},
         {"target": f"{DISPATCH}:fast_encode", "range": "pb.moe.encode"},
         {"target": f"{DISPATCH}:fast_decode", "range": "pb.moe.decode"}]
BACKWARD = ("_EncodeBackward", "_DecodeBackward")


def read(run):
    steps = run.trace_steps
    if not steps:
        return None
    fwd = _wraps.device_s(run, ["pb.moe.route", "pb.moe.encode",
                                "pb.moe.decode"])
    bwd = sum(v for k, v in run.trace.device_s_backward.items()
              if k in BACKWARD)
    return 1e3 * (fwd + bwd) / steps
