"""A run with the timed path broken underneath comes out not correct:
the harness's look for a chip is skipped (the CPU, tiny cells) and the
rest of a run is driven as on the card, with the cell's own limits. The
same runs unbroken come out correct."""

import pytest

from portbench.tests.conftest import run_module, tiny_cell

SERVE = "mixtral-8x7b.serve_decode"
TRAIN = ["mellum2-12b-a2.5b.moe_train"]


def verdict(cell, cpu, fault=None, seconds=1.0):
    run = run_module()
    ctx, _, _, _ = run.execute(cell, 20261018, seconds, 0, device=cpu,
                               fault=fault)
    return run.verdict(ctx), ctx.checks


def test_sound_serving_is_correct(cpu):
    ok, checks = verdict(tiny_cell(SERVE), cpu)
    assert ok, checks


def test_an_altered_token_is_caught(cpu):
    ok, checks = verdict(tiny_cell(SERVE), cpu, "alter_token")
    assert not ok, checks


@pytest.mark.parametrize("name", TRAIN)
def test_sound_training_is_correct(name, cpu):
    ok, checks = verdict(tiny_cell(name), cpu, seconds=0.3)
    assert ok, checks


@pytest.mark.parametrize("fault", ["half_batch", "unchanged_state"])
@pytest.mark.parametrize("name", TRAIN)
def test_a_broken_step_is_caught(name, fault, cpu):
    ok, checks = verdict(tiny_cell(name), cpu, fault, seconds=0.3)
    assert not ok, checks
