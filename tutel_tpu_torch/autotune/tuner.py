"""Config autotuner: time candidate configs, pick the fastest, persist
(counterpart: tutel_tpu/autotune/tuner.py).

Timing (`_time_chained`): the candidate's body runs eagerly n and then 3n
times, chained through its carry, and the per-step time is the slope
(t_3n - t_n) / 2n, which cancels the fixed cost of a run as the JAX
tuner's loop differencing inside one jit does. On the card the runs are
timed with CUDA events and a synchronize; on the CPU with
`time.perf_counter`.
"""

import json
import os
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from ..utils import tree_leaves

# what a candidate that cannot run raises (a config the layer refuses, a
# shape a kernel does not take): it is skipped
CANDIDATE_ERRORS = (ValueError, RuntimeError, TypeError)


class ConfigStore:
    """JSON config persistence (the JAX tuner's format; the path defaults
    to $CONFIG_STORE_PATH, and an empty path stores nothing)."""

    def __init__(self, path: Optional[str] = None):
        self.path = path or os.environ.get("CONFIG_STORE_PATH", "")

    def load(self) -> Dict[str, Any]:
        if self.path and os.path.exists(self.path):
            with open(self.path) as f:
                return json.load(f)
        return {}

    def save(self, data: Dict[str, Any]):
        if not self.path:
            return
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(self.path, "w") as f:
            json.dump(data, f, indent=2, sort_keys=True)


def _time_chained(step: Callable, init, iters: int) -> float:
    """Seconds a step: `step(i, carry) -> carry` run `iters` and
    `3 * iters` times from `init` after one warm-up run, the slope of the
    two."""
    cuda = any(isinstance(t, torch.Tensor) and t.is_cuda
               for t in tree_leaves(init))

    def chain(n):
        carry = init
        for i in range(n):
            carry = step(i, carry)
        return carry

    def timed(n):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            chain(n)
            end.record()
            torch.cuda.synchronize()
            return start.elapsed_time(end) / 1e3
        t0 = time.perf_counter()
        chain(n)
        return time.perf_counter() - t0

    with torch.no_grad():
        chain(iters)                                   # warm-up
        t_n = timed(iters)
        t_3n = timed(3 * iters)
    return max((t_3n - t_n) / (2 * iters), 1e-9)


def tune(make_step: Callable[[Any], Any], configs: List[Any], init,
         iters: int = 5, key_fn=str, store: Optional[ConfigStore] = None,
         store_key: str = "default", verbose=False) -> Dict[str, Any]:
    """Time `make_step(cfg)` for each config; return {"best": name,
    "timings": {name: seconds a step}}.

    make_step(cfg) returns a body fn(i, carry) -> carry. A config whose
    step raises one of CANDIDATE_ERRORS is skipped (the parted solver's
    invalid-candidate pruning); with none left, RuntimeError.
    """
    results = {}
    for cfg in configs:
        name = key_fn(cfg)
        try:
            dt = _time_chained(make_step(cfg), init, iters)
        except CANDIDATE_ERRORS as e:
            if verbose:
                print(f"[tune] {name}: skipped ({type(e).__name__}: {e})")
            continue
        results[name] = dt
        if verbose:
            print(f"[tune] {name}: {dt * 1e3:.3f} ms/step")
    if not results:
        raise RuntimeError("no valid tuning candidate survived")
    best = min(results, key=results.get)
    out = {"best": best, "timings": results}
    if store is not None:
        data = store.load()
        data[store_key] = out
        store.save(data)
    return out


def moe_candidates(layer, overlap_degrees=(1, 2, 4),
                   megablocks_sizes=(0, 1, 4), training=False,
                   dropless=None) -> List[dict]:
    """The MoE layer's semantically equal per-call configs: adaptive_r x
    the all-to-all overlap degree; megablocks narrowing (inference, one
    rank, several local experts); ragged expert parallelism (dropless,
    several ranks, no slicing). Constructor-level knobs are
    `layer_variant_candidates`'."""
    if dropless is None:
        dropless = all(g.capacity_factor == 0 for g in layer.gates)
    cands = []
    rs = [r for r in layer.valid_rs if r > 0] or [1]
    for r in rs:
        for deg in overlap_degrees:
            cands.append({"adaptive_r": r, "a2a_ffn_overlap_degree": deg})
    if not training and layer.world_size == 1 \
            and layer.num_local_experts > 1:
        for m in megablocks_sizes:
            if m > 0:
                cands.append({"megablocks_size": m})
    if dropless and layer.world_size > 1 and layer.sharded_count == 1:
        cands.append({"use_ragged_ep": True})
    return cands


def layer_variant_candidates(use_2dh_hosts=(), a2a_dtypes=()) -> List[dict]:
    """Constructor-level variants for `tune_layer_variants`: the 2DH
    all-to-all per host count, and payload types of the all-to-all (these
    change the numbers: pass them only where that is acceptable)."""
    cands = [{}]
    for hosts in use_2dh_hosts:
        cands.append({"use_2dh": True, "num_hosts": hosts})
    for dt in a2a_dtypes:
        cands.append({"a2a_dtype": dt})
    return cands


def _body(layer, key, training, cfg):
    """A chained step of the layer: the carry (params, x, acc) feeds the
    output's sum back into the next input (scaled to nothing), so each
    call depends on the one before."""
    def step(i, carry):
        p, xx, acc = carry
        out, _ = layer(p, xx + (acc * 1e-20).to(xx.dtype), key=key,
                       training=training, **cfg)
        return p, xx, acc + torch.sum(out.float()) * 1e-9
    return step


def _start(params, x):
    return params, x, torch.zeros((), dtype=torch.float32, device=x.device)


def tune_layer_variants(make_layer: Callable[..., Any], params, x,
                        variants: Optional[List[dict]] = None, key=None,
                        iters: int = 5, training=False,
                        store: Optional[ConfigStore] = None,
                        store_key: str = "moe_layer", verbose=False
                        ) -> Dict[str, Any]:
    """Time layer-construction variants (use_2dh, a2a_dtype, ...):
    make_layer(**overrides) builds a MOELayer that takes the same
    parameter tree (this rank's shard). key: a torch.Generator for the
    training gate noise. Returns {"best": the JSON of the overrides,
    "timings": {...}}."""
    variants = variants if variants is not None \
        else layer_variant_candidates()

    def key_fn(overrides):
        return json.dumps({k: str(v) for k, v in overrides.items()},
                          sort_keys=True)

    return tune(lambda o: _body(make_layer(**o), key, training, {}),
                variants, _start(params, x), iters=iters, key_fn=key_fn,
                store=store, store_key=store_key, verbose=verbose)


def tune_moe(layer, params, x, key=None, candidates=None, iters: int = 5,
             training=False, store: Optional[ConfigStore] = None,
             store_key: str = "moe", verbose=False) -> Dict[str, Any]:
    """The fastest per-call config of this layer at this input shape. The
    winner applies per call:
        best = json.loads(result["best"])
        layer(params, x, **best)
    """
    candidates = candidates if candidates is not None \
        else moe_candidates(layer, training=training)
    return tune(lambda cfg: _body(layer, key, training, cfg), candidates,
                _start(params, x), iters=iters,
                key_fn=lambda c: json.dumps(c, sort_keys=True),
                store=store, store_key=store_key, verbose=verbose)
