"""The control (the reference in bfloat16 in the program's place) comes out
as not correct: on the CPU at a small size, and on the card at the cell's
own size on three seeds."""

import pytest

from portbench.harness import spec
from portbench.tests.smallcells import cells, small


def _fails(bench, cell, cfg, tr, seeds, device, seconds):
    import torch

    from portbench.control import readings

    out = []
    for seed in seeds:
        got = readings(bench, cell, seed, seconds, device, torch.bfloat16, None, cfg, tr)
        out.append([k for k, v in got["control"].items() if v > cfg["limits"][k]])
    return out


@pytest.mark.parametrize("cell", cells())
def test_control_is_not_correct_small(cell):
    import torch

    bench, w, cfg, tr = small(cell)
    assert all(_fails(bench, w, cfg, tr, [3, 2 ** 31 + 9], torch.device("cpu"), 1.0))


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control at the cell's own size")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", cells())
def test_control_is_not_correct_on_the_card(cell, card):
    bench = spec.load_benchmark()
    w = spec.workload(bench, cell)
    cfg, tr = spec.config(bench, w["config"]), spec.traffic(w["traffic"])
    assert all(_fails(bench, w, cfg, tr, [11, 2147483660, 13], card, 8.0))
