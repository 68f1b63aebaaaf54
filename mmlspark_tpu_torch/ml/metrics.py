"""Classification metrics on host arrays.

The port's copy of ``confusion_matrix`` from
``mmlspark_tpu/ml/metrics.py``: the same counts, in numpy. The evaluator
stages (``ComputeModelStatistics``) are not ported.
"""

from __future__ import annotations

import numpy as np


def confusion_matrix(y: np.ndarray, pred: np.ndarray, k: int) -> np.ndarray:
    """``[k, k]`` counts, true class by row and predicted class by column,
    over rows whose codes are in ``[0, k)``. Out-of-range codes (the
    indexers' -1 "unseen" sentinel, or ``k`` and past) are left out
    rather than wrapped into the last class by negative indexing."""
    y, pred = np.asarray(y), np.asarray(pred)
    cm = np.zeros((k, k), dtype=np.int64)
    valid = (y >= 0) & (y < k) & (pred >= 0) & (pred < k)
    np.add.at(cm, (y[valid], pred[valid]), 1)
    return cm
