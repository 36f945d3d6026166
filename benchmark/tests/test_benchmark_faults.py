"""A whole run, without the look for a card, with the timed path broken
underneath: each fault a cell can have, and the control (the plain
reference in float8 in the program's place), make ``correct`` false under
the real cells' limits. At a tiny size on the CPU."""

import pytest

from toy_cells import toy_root

from benchmark import run
from benchmark.lib import faults


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return toy_root(tmp_path_factory.mktemp("toy"))


def _run(root, cell, seed=3_141_592_653_589):
    args = run.parse(["--workload", cell, "--seed", str(seed),
                      "--seconds", "0.2", "--trace", "0"])
    return run.run(args, device="cpu", root=root)


def test_sound_runs_pass(root):
    assert _run(root, "toy.train")["correct"] is True
    assert _run(root, "toy.prefill")["correct"] is True


@pytest.mark.parametrize("cell, fault, number", [
    ("toy.train", "unchanged_state", "change_gap"),
    ("toy.train", "half_batch", "grad_gap"),
    ("toy.prefill", "altered_answer", "max_gap"),
])
def test_a_planted_fault_fails(root, cell, fault, number):
    with faults.FAULTS[fault]():
        out = _run(root, cell)
    assert out["correct"] is False
    c = out["checks"][number]
    assert c["value"] > c["limit"]


def test_a_fault_after_set_up_fails_on_the_window_step(root):
    # the three steps of set-up are sound; the window's are not
    with faults.late_half_batch():
        out = _run(root, "toy.train")
    assert out["correct"] is False
    c = out["checks"]
    assert all(c[k]["value"] <= c[k]["limit"]
               for k in ("loss_gap", "grad_gap", "change_gap"))
    assert c["window_grad_gap"]["value"] > c["window_grad_gap"]["limit"]


@pytest.mark.parametrize("cell", ["toy.train", "toy.prefill"])
def test_the_control_fails(root, cell):
    with faults.reference_in_place("fp8"):
        out = _run(root, cell)
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


def test_patches_are_undone(root):
    from ompi_tpu_torch.models import transformer as tfm

    before = (tfm.forward, tfm.make_train_step)
    with faults.reference_in_place("fp8"), faults.half_batch():
        assert tfm.make_train_step is not before[1]
    assert (tfm.forward, tfm.make_train_step) == before
