"""``correct`` comes out false when the timed path is broken underneath:
each fault of faults.py planted in the program, a run driven at the mix's
small CPU shapes with the look for a chip skipped. And the control, run in
the program's place on the card at the cell's own size on three seeds,
fails too, as do the faults that show only at that size (``cuda``:
skipped without a card)."""

import pytest

from benchmark import faults, run
from benchmark.core import registry
from benchmark.tests.helpers import benchmark_json, cells, cpu_overrides


def _generator(workload):
    return registry.resolve(benchmark_json(), workload).traffic["generator"]


@pytest.mark.parametrize("workload,fault", [(w, f) for w in cells()
                                            for f in faults.FAULTS[_generator(w)]])
def test_planted_fault_is_not_correct(workload, fault):
    # a window long enough that every sampled window runs
    with faults.plant(_generator(workload), fault):
        r = run.run_cell(workload, 2 ** 31 + 3, 2.0, False, device="cpu",
                         require_chips=False, overrides=cpu_overrides(workload), check_imports=False)
    assert r["correct"] is False, r["checks"]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control runs at the cell's own size")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", cells())
def test_control_is_not_correct(workload, card):
    for seed in (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103):
        r = run.run_cell(workload, seed, 6.0, False, control=True, check_imports=False)
        assert r["correct"] is False, (seed, r["checks"])


@pytest.mark.cuda
@pytest.mark.parametrize("workload,fault", [(w, f) for w in cells()
                                            for f in faults.ON_CHIP[_generator(w)]])
def test_fault_at_the_cells_size_is_not_correct(workload, fault, card):
    for seed in (2 ** 31 + 201, 2 ** 31 + 202, 2 ** 31 + 203):
        with faults.plant(_generator(workload), fault):
            r = run.run_cell(workload, seed, 11.0, False, check_imports=False)
        assert r["correct"] is False, (seed, r["checks"])
