"""A configuration, a cell and a per-layer metric are added as new files
and found by their names, with no edit to a file that is there."""

import json
import shutil

from portbench import harness


def test_new_files_are_found_by_name(tmp_path):
    here = tmp_path / "portbench"
    shutil.copytree(harness.HERE, here,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(here): p.read_bytes()
              for p in here.rglob("*") if p.is_file()}
    cfg = json.loads((here / "configs" / "mixtral-8x7b.json").read_text())
    cfg["name"] = "other-moe"
    (here / "configs" / "other-moe.json").write_text(json.dumps(cfg))
    cell = json.loads((here / "workloads"
                       / "mixtral-8x7b.serve_decode.json").read_text())
    cell["config"] = "other-moe"
    cell["params"]["clients"] = 64
    (here / "workloads" / "other-moe.chat.json").write_text(
        json.dumps(cell))
    (here / "metrics" / "queue_depth.serve.py").write_text(
        "WRAPS = []\n\ndef read(run):\n    return run.rec['prefills']\n")
    found = harness.cell("other-moe.chat", here=here)
    assert found["config_data"]["name"] == "other-moe"
    assert found["params"]["clients"] == 64
    metric = harness.module("metrics", "queue_depth.serve", here=here)
    assert metric.read(type("R", (), {"rec": {"prefills": 3}})()) == 3
    bench = {"end_to_end": [], "per_layer": [
        {"name": "queue_depth.serve", "workloads": ["other-moe.chat"]},
        {"name": "everywhere"}]}
    assert [m["name"] for m in harness.metrics_of(
        bench, "other-moe.chat", "per_layer")] == ["queue_depth.serve",
                                                    "everywhere"]
    after = {p.relative_to(here): p.read_bytes()
             for p in here.rglob("*") if p.is_file()
             and "__pycache__" not in p.parts}
    assert all(after[k] == v for k, v in before.items())


def test_every_name_in_the_benchmark_has_its_files():
    bench = harness.benchmark()
    for w in bench["workloads"]:
        cell = harness.cell(w["name"])
        assert cell["config"] == w["config"]
        assert cell["chips"] == w["chips"]
        assert cell["why"] == w["why"]
        harness.module("traffic", cell["generator"])
        assert (harness.HERE / "entries"
                / f"{cell['config_data']['entry']}.py").is_file()
        assert (harness.HERE / "reference"
                / f"{cell['config_data']['entry']}.py").is_file()
    for kind in ("end_to_end", "per_layer"):
        for m in bench[kind]:
            assert hasattr(harness.module("metrics", m["name"]), "read")
    for c in bench["configs"]:
        assert harness.load_json(harness.ROOT / c["file"])["name"] == \
            c["name"]
