"""Card cases: a small training cell on the card, correct.
Marked ``cuda``; they skip without a card.

    python -m pytest benchmark/tests -m cuda
"""

from __future__ import annotations

import pytest

from conftest import Args, small_cell


@pytest.fixture
def card():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("fm", [0, 8])
def test_small_training_cell_on_the_card(card, tmp_path, scratch_tmpdir, fm):
    from harness import train
    cell = small_cell(tmp_path, "train_packed", fm, file_batches=5,
                      warm_steps=1, trace_steps=2)
    result = train.run(cell, Args(2 ** 31 + 21, seconds=1.0, trace=1), 0.0)
    assert result["correct"], result["compared"]
    assert result["device"]["busy_s"] > 0
