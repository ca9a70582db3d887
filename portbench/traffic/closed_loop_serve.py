"""Closed-loop serving traffic over the port's `LmDecodeEngine`.

A cell's "params" fix the mix: `clients` callers, each sending its next
request the moment its previous one finishes; prompt and output lengths
log-uniform over [lo, hi]; the engine's `slots`, `chunk` and
`speculative_capacity`; `max_len`. Every seed gets the same output
lengths in the same order (so the same arrivals), the same prompt lengths
in every run of BAND consecutive requests, in its own order within each
run, and its own prompt tokens, so seeds change what is computed and not
how much: a window admits the same prompt tokens, to a few tenths of a
percent, whatever the seed.

The engine is driven through its public calls alone: `try_add` for each
request sent, then `step_chunk`, which prefills what was admitted and
decodes up to `chunk` steps, and hands back each request's new tokens
when it returns. Set-up builds the model and its INT4 experts from the
seed, sends the first cohort (one request a client) and runs a few
chunks, so every kernel is built and loaded before the window. With
`stagger_first_cohort` the first cohort's outputs are cut to a share of
their length drawn evenly over (0, 1], so completions spread from the
window's start. The window then runs chunks until `seconds` have passed.

Time to first token runs from a request's send to the return of the
`step_chunk` that first hands it tokens: the one that prefilled it, so it
holds the prefill and that chunk's decode steps (clients equal slots, so
a request sent is admitted at the next chunk and waits in no queue). A
request lives longer than a window, so its time per output token is
taken over what the window saw of it: from the first `step_chunk` in the
window that handed it tokens to the last, over the tokens handed back
after the first. The live cache (positions held by the requests in the
slots, times the cache's bytes a position) is noted each chunk.

After the window a sample of finished requests, the longest among them,
is checked against the plain reference (`check`). `step_chunk` never
hands back the prefill's token, so the check takes that one token from
the engine's record of the request (what `LmDecodeEngine.run` returns)
and the rest from what the client received."""

import math

import numpy as np
import torch

from tutel_tpu_torch.serving import LmDecodeEngine, LmRequest

from portbench import weights

POOL = 8192          # request sizes a run can draw before they repeat
BAND = 32            # requests in a run that holds every prompt band once
ARRIVALS_SEED = 0    # the output lengths and first-cohort shares
WARM_CHUNKS = 2      # decode chunks in set-up after the first cohort


def sizes(lo, hi, n, rng):
    """n log-uniform lengths in [lo, hi] at evenly spaced quantiles, in an
    order drawn from rng."""
    u = (np.arange(n) + 0.5) / n
    vals = np.floor(lo * (hi / lo) ** u + 0.5).astype(np.int64)
    return vals[rng.permutation(n)]


def banded_sizes(lo, hi, n, band, rng):
    """The n lengths of `sizes`, laid out so that each run of `band`
    consecutive lengths holds one from each of `band` equally likely
    bands of [lo, hi], the same ones for every rng; rng orders each
    run."""
    runs = n // band
    u = (np.arange(band)[None, :]
         + (np.arange(runs)[:, None] + 0.5) / runs) / band
    vals = np.floor(lo * (hi / lo) ** u + 0.5).astype(np.int64)
    return rng.permuted(vals, axis=1).reshape(-1)


class Traffic:
    """The seed's request stream: request k has prompt_len[k] tokens and
    asks for out_len[k]. The output lengths, and so the closed loop's
    arrivals, are the cell's and the same for every seed (drawn from
    ARRIVALS_SEED); so are the prompt lengths of each run of BAND
    requests, which the seed orders within the run. The seed draws the
    prompts."""

    def __init__(self, p, vocab, seed):
        self.rng = np.random.default_rng(seed)
        self.prompt_len = banded_sizes(*p["prompt_len"], POOL, BAND,
                                       self.rng)
        self.out_len = sizes(*p["output_len"], POOL,
                             np.random.default_rng(ARRIVALS_SEED))
        self.vocab = vocab
        self.k = 0

    def next(self, share=1.0):
        i = self.k % POOL
        self.k += 1
        tp = int(self.prompt_len[i])
        new = max(1, int(math.ceil(share * int(self.out_len[i]))))
        prompt = self.rng.integers(0, self.vocab, tp).astype(np.int32)
        return LmRequest(uid=self.k - 1, prompt=prompt, max_new_tokens=new)


class Loop:
    """The engine and its clients: who was sent when, and what came back
    when."""

    def __init__(self, engine, traffic, clock):
        self.engine, self.traffic, self.clock = engine, traffic, clock
        self.sent, self.first_t, self.last_t = {}, {}, {}
        self.want, self.got, self.prompt, self.received = {}, {}, {}, {}
        self.queue = []
        self.live = set()           # admitted and not finished
        # the cache's bytes a position: every cache tensor is [slots,
        # max_len, ...] or [slots, heads, max_len]
        cache_bytes = sum(t.numel() * t.element_size()
                          for lc in engine.cache for t in lc.values())
        self.pos_bytes = cache_bytes / (engine.max_batch
                                        * engine.model.cfg.max_len)
        # token deliveries in the window: each request's first and last
        # delivery time and the tokens delivered after its first
        self.window = None
        self.ev_first, self.ev_last, self.ev_after = {}, {}, {}
        self.live_positions = []

    def deliver(self, uid, t, n):
        if self.window is None or n <= 0:
            return
        if uid not in self.ev_first:
            self.ev_first[uid], self.ev_after[uid] = t, 0
        else:
            self.ev_after[uid] += n
        self.ev_last[uid] = t

    def send(self, req, t):
        self.sent[req.uid] = t
        budget = self.engine.model.cfg.max_len - len(req.prompt) - 1
        self.want[req.uid] = min(req.max_new_tokens, budget)
        self.prompt[req.uid] = len(req.prompt)
        self.got[req.uid] = 0
        self.queue.append(req)

    def chunk(self, n_steps):
        """Admit what was sent (`try_add`), then one `step_chunk`. Returns
        what the chunk did: requests prefilled, their prompt tokens and
        the sum of their causal attention spans, tokens produced (each
        prefill's one and the decoded ones), the sum of the decoded
        tokens' context lengths, the finished uids and the chunk's end on
        the clock."""
        eng = self.engine
        admitted = []
        while self.queue and eng.try_add(self.queue[0]):
            req = self.queue.pop(0)
            admitted.append(req.uid)
            self.live.add(req.uid)
            self.got[req.uid] = 1       # the prefill's token
            self.received[req.uid] = []
        res = eng.step_chunk(n_steps)
        t = self.clock()
        decoded, ctx_sum = 0, 0
        for uid, toks in res.items():
            n, start = len(toks), self.prompt[uid] + self.got[uid]
            ctx_sum += n * start + n * (n - 1) // 2
            self.got[uid] += n
            self.received[uid].extend(toks)
            decoded += n
        for uid in admitted:
            self.first_t[uid] = t
            self.deliver(uid, t, 1 + len(res.get(uid, ())))
        fresh = set(admitted)
        for uid, toks in res.items():
            if uid not in fresh:
                self.deliver(uid, t, len(toks))
        done = sorted(u for u in self.live if self.got[u] >= self.want[u])
        for uid in done:
            self.last_t[uid] = t
            self.live.discard(uid)
        if self.window is not None:
            self.live_positions.append(sum(self.prompt[u] + self.got[u]
                                           for u in self.live))
        tps = [self.prompt[u] for u in admitted]
        return {"prefills": len(admitted), "prompt_tokens": sum(tps),
                "prompt_spans": sum(n * (n + 1) // 2 for n in tps),
                "tokens": decoded + len(admitted), "decoded": decoded,
                "decode_ctx": ctx_sum, "done": done, "t": t}


COUNTS = ("prefills", "prompt_tokens", "prompt_spans", "tokens", "decoded",
          "decode_ctx")


def run(ctx):
    p = ctx.params
    cfg = ctx.config
    model, params = ctx.entry.build_serve(cfg, p["max_len"], ctx.seed,
                                          ctx.device)
    engine = LmDecodeEngine(model, params, max_batch=p["slots"],
                            speculative_capacity=p["speculative_capacity"])
    ctx.apply_fault(engine)
    traffic = Traffic(p, cfg["port"]["vocab_size"], ctx.seed)
    loop = Loop(engine, traffic, ctx.clock)
    # the first cohort: one request a client, prefilled in set-up; its
    # outputs cut to evenly spread shares of their length
    shares = (np.arange(p["clients"]) + 1.0) / p["clients"]
    shares = shares[np.random.default_rng(ARRIVALS_SEED + 7).permutation(
        p["clients"])]
    t = ctx.clock()
    for c in range(p["clients"]):
        share = float(shares[c]) if p.get("stagger_first_cohort") else 1.0
        loop.send(traffic.next(share), t)
    for _ in range(WARM_CHUNKS):
        out = loop.chunk(p["chunk"])
        for _ in out["done"]:
            loop.send(traffic.next(), out["t"])
    ctx.sync()
    rec = dict.fromkeys(COUNTS, 0)
    steps0, t0 = engine.stats["steps"], ctx.clock()
    loop.window = t0
    ctx.window_start(t0)
    while ctx.running():
        ctx.maybe_trace(lambda: engine.stats["steps"])
        out = loop.chunk(p["chunk"])
        for k in COUNTS:
            rec[k] += out[k]
        ctx.maybe_trace(lambda: engine.stats["steps"])
        for _ in out["done"]:
            loop.send(traffic.next(), out["t"])
    t1 = ctx.clock()
    ctx.window_end(t1, lambda: engine.stats["steps"])
    rec["steps"] = engine.stats["steps"] - steps0
    rec["spec_retries"] = engine.stats["spec_retries"]
    rec["ttft_s"] = [ft - loop.sent[u] for u, ft in loop.first_t.items()
                     if ft >= t0]
    rec["tpot_s"] = [(loop.ev_last[u] - loop.ev_first[u]) / n
                     for u, n in loop.ev_after.items() if n > 0]
    rec["attempted"] = sum(1 for s in loop.sent.values() if s >= t0)
    rec["failed"] = 0
    live = loop.live_positions
    ctx.note(live_kv_bytes_mean=loop.pos_bytes * sum(live) / max(1, len(live)),
             live_kv_bytes_max=loop.pos_bytes * max(live, default=0),
             kv_pool_bytes=loop.pos_bytes * p["slots"] * p["max_len"])
    ctx.read_memory()
    served = {u: engine._generated[u][:1] + loop.received[u]
              for u in loop.last_t}
    # the prompts are the seed's: draw them again
    replay = Traffic(p, cfg["port"]["vocab_size"], ctx.seed)
    prompts = {}
    for k in range(traffic.k):
        r = replay.next()
        if k in served:
            prompts[k] = r.prompt
    del engine, model, params, loop
    ctx.free()
    ctx.outcome(rec, check(ctx, served, prompts))


def sample(ctx, served, n):
    """The longest finished request and n - 1 more drawn from the seed."""
    uids = sorted(served)
    if not uids:
        return []
    longest = max(uids, key=lambda u: len(served[u]))
    rest = [u for u in uids if u != longest]
    rng = np.random.default_rng(ctx.seed + 11)
    pick = list(rng.choice(rest, size=min(n - 1, len(rest)),
                           replace=False)) if rest else []
    return [longest] + [int(u) for u in pick]


def gaps(ctx, ref_weights, uids, served, prompts, prec_name="fp32"):
    """Over the sampled requests' served tokens: the gap by which each
    token's reference logit lies below the reference's best at its
    position; and, with prec_name "fp8", the gap of the token the control
    puts first there. Returns (the program's mean gap, the control's mean
    gap or None, tokens compared); the quantiles, the widest and the share
    of tokens that are not the reference's first choice go to the
    notes."""
    from portbench.reference.numerics import Precision
    ref = ctx.reference
    port = ctx.config["port"]
    n = 0
    every, every_ctl = [], []
    for u in uids:
        prompt = torch.as_tensor(np.asarray(prompts[u], np.int64))
        toks = torch.as_tensor(np.asarray(served[u], np.int64))
        seq = torch.cat([prompt, toks[:-1]]).to(ctx.device)
        tp = len(prompt)
        lg = ref.logits(ref_weights, seq, port)[tp - 1:]
        best = lg.max(dim=-1).values
        got = lg.gather(1, toks.to(ctx.device)[:, None])[:, 0]
        every.append((best - got).float().cpu())
        n += len(toks)
        if prec_name != "fp32":
            ctl = ref.logits(ref_weights, seq, port,
                             Precision(prec_name))[tp - 1:]
            pick = ctl.argmax(dim=-1)
            every_ctl.append((best - lg.gather(1, pick[:, None])[:, 0])
                             .float().cpu())
        del lg
    ctx.note(gap_stats=gap_stats(every),
             control_gap_stats=gap_stats(every_ctl) if every_ctl else None)
    mean = float(torch.cat(every).mean()) if every else float("inf")
    mean_ctl = float(torch.cat(every_ctl).mean()) if every_ctl else None
    return mean, mean_ctl, n


def gap_stats(every):
    """Quantiles of the per-token gaps and the share of tokens that are
    not the reference's first choice."""
    if not every:
        return None
    g = torch.cat(every)
    q = torch.quantile(g, torch.tensor([0.5, 0.9, 0.99, 0.999]))
    return {"n": int(g.numel()), "q50_90_99_999": q.tolist(),
            "max": float(g.max()), "mean": float(g.mean()),
            "share_not_first": float((g > 0).float().mean())}


def check(ctx, served, prompts):
    """The numbers compared, each with its limit. With a control, the
    control stands in the program's place: its picks are what is
    compared, and the program's number goes to the notes."""
    from portbench.reference.numerics import no_tf32
    no_tf32()
    uids = sample(ctx, served, ctx.params["check_requests"])
    ref_weights = weights.lm(ctx.config["port"], ctx.params["max_len"],
                             ctx.seed, ctx.device)
    mean, mean_ctl, n = gaps(ctx, ref_weights, uids, served, prompts,
                             ctx.control or "fp32")
    ctx.note(tokens_checked=n, requests_checked=len(uids),
             program_logit_gap_mean=mean, control_logit_gap_mean=mean_ctl)
    value = mean_ctl if ctx.control else mean
    return {"logit_gap_mean": {"value": value,
                               "limit": ctx.cell["limits"]["logit_gap_mean"]}}
