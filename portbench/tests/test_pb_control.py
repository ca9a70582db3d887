"""The control: the reference put in the program's place and computed one
precision lower than the configuration states (float8 e4m3 operands for
bfloat16). A run with the control compares the control's numbers, so
its verdict is the control's. At a size a test run holds (the CPU) the
control has to read at least three times what the program reads; at the
cell's own size (the card) the run has to come out not correct."""

import pytest

from portbench import harness
from portbench.reference.numerics import Precision
from portbench.tests.conftest import run_module, tiny_cell


def test_serving_control_reads_three_times_the_program(cpu):
    run = run_module()
    cell = tiny_cell("mixtral-8x7b.serve_decode")
    cell["params"]["check_requests"] = 6
    ctx, _, _, _ = run.execute(cell, 424242, 1.5, 0, device=cpu,
                               control="fp8")
    control = ctx.checks["logit_gap_mean"]["value"]
    assert control == ctx.notes["control_logit_gap_mean"]
    program = ctx.notes["program_logit_gap_mean"]
    assert control >= 3 * program


@pytest.mark.parametrize("name", ["mellum2-12b-a2.5b.moe_train"])
def test_training_control_fails_a_limit(name, cpu):
    run = run_module()
    cell = tiny_cell(name)
    ctx, _, _, _ = run.execute(cell, 424243, 0.3, 0, device=cpu,
                               control="fp8")
    control = {k: c["value"] for k, c in ctx.checks.items()}
    assert all(control[k] == ctx.notes["control"][k] for k in control)
    program = ctx.notes["gaps"]
    assert any(control[k] >= 3 * program[k] for k in control), (control,
                                                                 program)


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in
                                  harness.benchmark()["workloads"]])
def test_control_fails_at_the_cells_size(name, card):
    run = run_module()
    cell = harness.cell(name)
    seconds = 1.0 if cell["generator"] == "train_loop" else 20.0
    ctx, _, _, _ = run.execute(cell, 2147483701, seconds, 0, device=card,
                               control="fp8")
    print(name, "control", {k: c["value"] for k, c in ctx.checks.items()},
          "program", ctx.notes.get("gaps",
                                   ctx.notes.get("program_logit_gap_mean")))
    assert not run.verdict(ctx), ctx.checks


def test_fp8_rounds_to_three_mantissa_bits():
    import torch
    x = torch.tensor([1.0, 1.0625, 1.125, 448.0, -3.3])
    y = Precision("fp8").r(x)
    assert y[0] == 1.0 and y[2] == 1.125 and y[3] == 448.0
    assert y[1] in (1.0, 1.125)
    assert Precision("fp32").r(x).equal(x)
    with pytest.raises(ValueError):
        Precision("int4")
