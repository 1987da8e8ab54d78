"""Generic evaluation helpers (numpy only; a copy of
`mobileposer_tpu/utils/testing.py`).

Behavioral parity target: reference `articulate/utils/torch/test.py:12-43`
(`test`, `test_next_batch`): run a prediction function over a dataset (or a
single batch) and reduce per-batch losses. Library surface only — the main
pipeline uses evaluation/ instead.
"""

from __future__ import annotations

from typing import Callable, Iterable, Sequence

import numpy as np


def evaluate_over_dataset(predict_fn: Callable, loss_fns: Sequence[Callable],
                          batches: Iterable, verbose: bool = False):
    """Mean of each loss over all batches (reference: test.py:12-31).

    predict_fn(batch) -> prediction; each loss_fn(prediction, batch) -> float.
    """
    totals = np.zeros(len(loss_fns))
    n = 0
    for batch in batches:
        pred = predict_fn(batch)
        for i, loss_fn in enumerate(loss_fns):
            totals[i] += float(loss_fn(pred, batch))
        n += 1
        if verbose:
            print(f"batch {n}: " + " ".join("%.6f" % (t / n) for t in totals))
    if n == 0:
        raise ValueError("evaluate_over_dataset got no batches — all-zero "
                         "losses would be indistinguishable from a perfect "
                         "model")
    return totals / n


def evaluate_next_batch(predict_fn: Callable, loss_fns: Sequence[Callable],
                        batches: Iterable):
    """Losses on just the next batch (reference: test_next_batch,
    test.py:34-43)."""
    batch = next(iter(batches))
    pred = predict_fn(batch)
    return np.array([float(loss_fn(pred, batch)) for loss_fn in loss_fns])
