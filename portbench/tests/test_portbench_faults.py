"""The check fails what it must. Runs are driven on the CPU (the harness's
look for a chip skipped) under the cells' own limits: a sound run is
correct; with the timed path broken underneath, once for each fault its
cell can have, and with the cell's control in the program's place (the
int8 serving path of kernel 2's twin for the inference cells, the float8
reference for training), `correct` comes out false by a number over its
limit. The inference cells run at their published widths with a few clips
(the generation chain over 50 of the 1000 steps), where the readings lie as
on the card (PERF.md); training and the faults run tiny."""
import pytest

from portbench.tests import tiny

FULL = {  # published widths, few clips: (cell, traffic overrides, config overrides)
    "humanml_generate": ({"clips": 2, "check_among": 1}, {"diffusion_steps": 50}),
    "xia_transfer": ({"clips": 8, "library": 20, "check_among": 2, "check_calls": 1}, {}),
    "humanml_transfer": ({"clips": 4, "library": 20, "check_among": 2, "check_calls": 1}, {}),
}
FAULTS = [("humanml_generate", "altered_answer"), ("humanml_generate", "half_rows"),
          ("xia_transfer", "altered_answer"), ("humanml_transfer", "altered_answer"),
          ("xia_pretrain", "unchanged_state"), ("xia_pretrain", "half_batch")]


def run_full(cell: str, control: bool, fault=None):
    import time

    from portbench.harness import cell as cellmod

    mix, cfg = FULL[cell]
    return cellmod.run(cell, 2147483659, 0.1, False, time.perf_counter(), device="cpu",
                       control=control, fault=fault, overrides={"config": cfg, "traffic": mix})


def over(rows) -> list:
    return [k for k, v, lim in rows if lim is not None and v > lim]


@pytest.mark.parametrize("cell", sorted(FULL))
@pytest.mark.parametrize("control", [False, True], ids=["program", "control"])
def test_inference_cells_pass_the_program_and_fail_the_control(cell, control):
    result, rows = run_full(cell, control)
    assert result["correct"] is not control and bool(over(rows)) is control, rows


@pytest.mark.parametrize("cell", ["xia_pretrain"])
@pytest.mark.parametrize("control", [False, True], ids=["program", "control"])
def test_training_cells_pass_the_program_and_fail_the_control(cell, control):
    result, rows = tiny.run(cell, seed=2147483659, control=control)
    assert result["correct"] is not control and bool(over(rows)) is control, rows


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_fault_makes_the_run_not_correct(cell, fault):
    if cell in FULL:
        result, rows = run_full(cell, False, fault)
    else:
        result, rows = tiny.run(cell, seed=2147483659, fault=fault)
    assert not result["correct"] and over(rows), rows
