"""On the card: the control (the reference in the program's place, in
TF32, where the configuration states float32 with TF32 off) and the
planted faults (half of every batch left out, every step returning its
state unchanged, a ragged step's padded rows counted in its loss) fail the
cells' comparison, at a size a test run holds
(the published widths, a cohort cut to a few dozen patients); the program
passes it. Run on the card with

    python -m pytest --noconftest -p no:cacheprovider port_bench/tests -m cuda
"""

import pytest
import torch

import pbench_tiny  # noqa: F401  (puts the checkout on sys.path)
from port_bench.core import registry


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the control runs in TF32 there)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("cell_name", ["pm_train_b8", "sf_train_b8"])
def test_control_and_faults_fail_program_passes(card, cell_name):
    cell = registry.Cell(cell_name)
    # fold 0 trains 52 rows of the flagship's cohort and 29 of simple
    # fusion's: the last set-up step is as ragged as in the cells (4, 5)
    cell.traffic["cohort"]["patterns"] = [
        [1, 1, 1, 1, 44], [0, 1, 1, 1, 20], [0, 0, 1, 0, 10]]
    rows = []
    registry.load_driver(cell.traffic["driver"]).readings(
        cell, [5, 6], [7, 8], None, rows.append, device=card)
    for row in rows:
        fails = [k for k, lim in cell.limits.items()
                 if row["numbers"][k] > lim]
        if row["kind"] == "program":
            assert not fails, (fails, row["seed"], row["numbers"])
        else:
            assert fails, (row["kind"], row["seed"], row["numbers"])
