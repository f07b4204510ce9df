"""A short run of every cell on the card (skips without one): the result
line names the card and the run is correct."""

import json

import pytest

from uhdrbench import harness

CELLS = [w["name"] for w in json.loads(
    (harness.ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    res = harness.run_cell(cell, 2 ** 31 + 5, 3.0, False,
                           out=lambda s: None, err=lambda s: None)
    assert res["correct"] is True
    assert res["device"]["kind"] == torch.cuda.get_device_name(0)
