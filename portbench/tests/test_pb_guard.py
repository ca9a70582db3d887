"""No module a run imports has the top-level name jax, jaxlib, flax,
tutel_tpu or benchmarks; the port's own name, which begins with the JAX
package's, passes because names are compared whole."""

import json
import subprocess
import sys
import types

import pytest

from portbench import harness
from portbench.tests.conftest import ROOT, run_module


def test_names_are_compared_whole():
    ok = ["tutel_tpu_torch", "tutel_tpu_torch.ops.quant", "jaxtyping",
          "benchmarking", "portbench.run", "torch"]
    assert harness.forbidden_modules(ok) == []
    bad = ["tutel_tpu", "tutel_tpu.ops", "jax.numpy", "jaxlib.xla_client",
           "flax.linen", "benchmarks.bench_lm_serving"]
    assert harness.forbidden_modules(ok + bad) == [
        "benchmarks", "flax", "jax", "jaxlib", "tutel_tpu"]


def test_a_run_loads_none_of_them():
    """A whole tiny run on the CPU, in a fresh process, then the guard."""
    code = f"""
import sys, json, torch
sys.path.insert(0, {str(ROOT)!r})
from portbench.tests.conftest import tiny_cell, run_module
run = run_module()
cell = tiny_cell("mixtral-8x7b.serve_decode")
run.execute(cell, 3, 0.5, 0, device=torch.device("cpu"))
cell = tiny_cell("mellum2-12b-a2.5b.moe_train")
run.execute(cell, 3, 0.5, 0, device=torch.device("cpu"))
from portbench import harness
print(json.dumps([harness.forbidden_modules(),
                  sorted(m for m in sys.modules if m.startswith("tutel"))]))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    found, tutel = json.loads(out.stdout.strip().splitlines()[-1])
    assert found == []
    assert "tutel_tpu_torch" in tutel


def test_the_run_refuses_a_process_that_holds_one(monkeypatch, capsys):
    run = run_module()
    ctx = types.SimpleNamespace(checks={}, rec={"failed": 0,
                                                "attempted": 1},
                                notes={}, setup_s=1.0, window_s=1.0)
    monkeypatch.setattr(run, "execute",
                        lambda *a, **k: (ctx, {}, {}, None))
    monkeypatch.setitem(sys.modules, "tutel_tpu", types.ModuleType("x"))
    with pytest.raises(SystemExit) as e:
        run.main(["--workload", "mixtral-8x7b.serve_decode", "--seed", "1",
                  "--seconds", "1"])
    assert e.value.code != 0
    assert "tutel_tpu" in capsys.readouterr().err
