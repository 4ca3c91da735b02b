"""The batch kind of traffic: every seed gets the same slices, and each
batch other rows."""
from __future__ import annotations

import numpy as np
import pytest

from portbench.kinds.batch import batch_start


def test_batches_are_contiguous_slices_that_move_on():
    starts = batch_start(np.arange(200), 5_000_000, 65536)
    assert list(starts[:76]) == list(range(0, 76 * 65536, 65536))
    assert starts[76] == 76 * 65536 - (5_000_000 - 65536 + 1)
    assert np.all(starts + 65536 <= 5_000_000)
    # a table of one batch and a half: every batch other rows
    small = batch_start(np.arange(1000), 96367, 65536)
    assert len(np.unique(small)) == 1000 and np.all(small + 65536 <= 96367)
    with pytest.raises(ValueError):
        batch_start(0, 100, 101)
