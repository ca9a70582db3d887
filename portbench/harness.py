"""What every run shares: finding a cell's files by name, the import
guard, quantiles, the device description and the result line.

Each configuration, cell, traffic generator, program entry, reference and
metric is a file of its own, found by the name `BENCHMARK.json` or the
cell's file gives it:

    portbench/workloads/<cell>.json     the cell: config, generator, params
    portbench/configs/<config>.json     the configuration ("entry" names
                                        the program path it runs)
    portbench/traffic/<generator>.py    the traffic generator
    portbench/entries/<entry>.py        builds the port's objects
    portbench/reference/<entry>.py      the plain float32 reference
    portbench/metrics/<metric>.py       one metric: read(run) -> number
                                        or None
"""

import importlib.util
import json
import pathlib
import statistics
import sys

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names a run may never hold: the JAX package, JAX
# itself, and the benchmark of the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "tutel_tpu", "benchmarks")


def load_json(path):
    with open(path) as f:
        return json.load(f)


def benchmark(root=ROOT):
    return load_json(pathlib.Path(root) / "BENCHMARK.json")


def cell(name, here=HERE):
    """The cell's file with its configuration under "config_data"."""
    path = pathlib.Path(here) / "workloads" / f"{name}.json"
    if not path.is_file():
        raise KeyError(f"no cell {name!r} ({path} is missing)")
    c = load_json(path)
    c["name"] = name
    c["config_data"] = load_json(pathlib.Path(here) / "configs"
                                 / f"{c['config']}.json")
    return c


def module(kind, name, here=HERE):
    """portbench/<kind>/<name>.py, imported by its path (a name may hold
    dots)."""
    path = pathlib.Path(here) / kind / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no {kind} {name!r} ({path} is missing)")
    mod_name = f"portbench.{kind}._{name.replace('.', '_').replace('-', '_')}"
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def metrics_of(bench, cell_name, kind):
    """The `kind` ("end_to_end" or "per_layer") metrics of BENCHMARK.json
    that this cell reports: those that list it, and those that list no
    cells."""
    return [m for m in bench[kind]
            if "workloads" not in m or cell_name in m["workloads"]]


def forbidden_modules(modules=None):
    """Top-level names in `modules` (default sys.modules) that a run may
    not hold, each compared whole."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def quantile(values, q):
    """The q-quantile (0 < q < 1) of `values`, linear between order
    statistics (statistics.quantiles' inclusive method)."""
    vals = sorted(values)
    if not vals:
        return None
    if len(vals) == 1:
        return vals[0]
    return statistics.quantiles(vals, n=100, method="inclusive")[
        round(q * 100) - 1]


def result_line(correct, attempted, failed, metrics, device, checks,
                breakdown=None):
    """The run's last stdout line: correct, attempted, failed, metrics,
    device (and breakdown), then `checks` (each compared number with its
    limit) last."""
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return json.dumps(out)
