"""serve_mfu (model, the whole serving window): the matmul FLOPs of the
tokens prefilled and decoded in the window (prompt positions through
every block, causal attention over each prompt and each decoded token's
context, the LM head at each produced token) over the window times the
card's dense bf16 peak of 989 TFLOP/s, in %. Moves serve_tokens_per_s."""

from portbench.metrics import _work

WRAPS = []


def read(run):
    r, port = run.rec, run.config["port"]
    tokens = r["prompt_tokens"] + r["decoded"]
    pairs = r["prompt_spans"] + r["decode_ctx"] + r["decoded"]
    flops = _work.lm_forward(port, tokens, pairs, head_rows=r["tokens"])
    return 100.0 * flops / (run.window_s * _work.BF16_PEAK)
