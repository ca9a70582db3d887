"""A pool of W ranks for tests of the sharded code on the CPU.

`RankPool(world, init_dir)` spawns one process a rank (the "spawn" start
method: a fresh interpreter, one thread for torch), joins them in a gloo
process group through a file in `init_dir` (`system.
init_data_model_parallel` with a file:// init_method: no port to collide
between concurrent test workers), and keeps them for many calls:
`pool.run(fn, *args)` runs the module-level function `fn` in every rank
and returns the ranks' results in rank order. A rank that raises fails
the call with its traceback, and a call that outlasts `timeout` seconds
fails too; either way the pool stops its processes and starts new ones at
the next call. `close()` stops them (each join has a timeout).

The ranks import `fn`'s module by name, so that module must import
without side effects they cannot bear (the tests keep jax out of it).
"""

import importlib
import multiprocessing
import os
import queue
import traceback


def _rank_main(rank, world, init_file, tasks, results):
    import torch
    from . import system
    torch.set_num_threads(1)
    system.init_data_model_parallel(device="cpu",
                                    init_method=f"file://{init_file}",
                                    rank=rank, world_size=world)
    try:
        while True:
            task = tasks.get()
            if task is None:
                break
            module, name, args, kwargs = task
            try:
                fn = getattr(importlib.import_module(module), name)
                results.put((rank, True, fn(*args, **kwargs)))
            except Exception:                  # reported to the caller
                results.put((rank, False, traceback.format_exc()))
    finally:
        system.destroy()


class RankPool:
    """W spawned ranks in a gloo group (see module doc)."""

    def __init__(self, world, init_dir, timeout=120.0):
        self.world, self.init_dir, self.timeout = world, init_dir, timeout
        self._procs, self._starts = [], 0

    def _start(self):
        ctx = multiprocessing.get_context("spawn")
        self._starts += 1
        init_file = os.path.join(self.init_dir, f"init{self._starts}")
        self._tasks = [ctx.Queue() for _ in range(self.world)]
        self._results = ctx.Queue()
        self._procs = [ctx.Process(
            target=_rank_main, daemon=True,
            args=(r, self.world, init_file, self._tasks[r], self._results))
            for r in range(self.world)]
        for p in self._procs:
            p.start()

    def run(self, fn, *args, **kwargs):
        """fn(*args, **kwargs) in every rank; the results in rank order."""
        if not self._procs:
            self._start()
        for q in self._tasks:
            q.put((fn.__module__, fn.__name__, args, kwargs))
        got, errors = {}, []
        try:
            while len(got) + len(errors) < self.world:
                rank, ok, value = self._results.get(timeout=self.timeout)
                if ok:
                    got[rank] = value
                else:
                    errors.append(f"rank {rank}:\n{value}")
                    break
        except queue.Empty:
            errors.append(f"no result within {self.timeout} s "
                          f"({sorted(got)} answered)")
        if errors:
            self._stop(kill=True)
            raise RuntimeError("\n".join(errors))
        return [got[r] for r in range(self.world)]

    def _stop(self, kill=False):
        for p, q in zip(self._procs, getattr(self, "_tasks", [])):
            if kill:
                p.kill()
            else:
                q.put(None)
        for p in self._procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=30)
        self._procs = []

    def close(self):
        self._stop()
