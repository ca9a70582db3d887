"""first_token_p50_ms.serve (engine: the program's request events): the
median, over the requests whose `tutel.request.admit` (`try_add`) and
`tutel.request.first_token` (the prefill's token on the host) both fall
in the traced sub-window, of the time between the two: the admission's
wait for the next chunk and its prefill. Moves ttft_p90_ms."""

from portbench.harness import quantile
from portbench.metrics import _spans

WRAPS = []


def read(run):
    recs = _spans.records(run)
    if recs is None:
        return None
    admit = {r.attrs["uid"]: r.start_ns
             for r in _spans.named(recs, "tutel.request.admit")}
    waits = [r.start_ns - admit[r.attrs["uid"]]
             for r in _spans.named(recs, "tutel.request.first_token")
             if r.attrs["uid"] in admit]
    v = quantile(waits, 0.5)
    return None if v is None else v / 1e6
