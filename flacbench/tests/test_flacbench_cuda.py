"""The benchmark's path on the card at a test's size: a sound run of the
tiny cells is correct, a run whose timed path is broken underneath is
not, and the control is not (marked ``cuda``; they skip where no card is
present). The calls take the default route, as every cell's do, and the
segmented path that the real cells' default route chooses."""

import pytest

import claxon_tpu_torch as ct
from flacbench.control import control_counts
from flacbench.harness import run_cell
from flacbench.tests.tiny import answer_altered, half_left_out, tiny_bench

CELLS = ["tiny.device", "tiny.host"]
ROUTES = [None, "device"]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("segmentation", ROUTES, ids=["default", "segmented"])
@pytest.mark.parametrize("cell", CELLS)
def test_tiny_cells_on_the_card(card, tmp_path, monkeypatch, cell,
                                segmentation):
    bench = tiny_bench(tmp_path, monkeypatch, segmentation)
    result, _ = run_cell(bench, cell, 2**31 + 1234, 2.0, 1, device=card)
    assert result["correct"], result["compared"]
    assert result["device"]["platform"] == "gpu"
    assert result["device"]["busy_s"] > 0
    counts = control_counts(bench, cell, 2**31 + 1235, card)
    assert counts["mismatched_samples"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("fault", [half_left_out, answer_altered])
@pytest.mark.parametrize("segmentation", ROUTES, ids=["default", "segmented"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_on_the_card_is_not_correct(
        card, tmp_path, monkeypatch, cell, segmentation, fault):
    bench = tiny_bench(tmp_path, monkeypatch, segmentation)
    monkeypatch.setattr(ct, "decode_streams_device",
                        fault(ct.decode_streams_device))
    result, compared = run_cell(bench, cell, 2**31 + 1236, 2.0, 0,
                                device=card)
    assert not result["correct"]
    bad = {k for k, v, lim in compared if v > lim}
    assert bad == ({"uncovered_samples"} if fault is half_left_out
                   else {"mismatched_samples"})
