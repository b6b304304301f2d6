"""Dataset fetchers (reference ``python/pathway/stdlib/ml/datasets``):
downloads public classification datasets. Gated — this environment has no
network egress; pass local files to the parse helpers instead.

Copy of ``pathway_tpu/stdlib/ml/datasets.py``, over the port's Table API and engine nodes.
"""

from __future__ import annotations

from typing import Any

__all__ = ["load_mnist_stream", "parse_svm_file"]


def parse_svm_file(path: str, n_features: int) -> list[tuple]:
    """Parse an svmlight-format file into (vector, label) rows."""
    import numpy as np

    rows = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            label = int(float(parts[0]))
            vec = np.zeros(n_features)
            for tok in parts[1:]:
                idx, val = tok.split(":")
                vec[int(idx) - 1] = float(val)
            rows.append((vec, label))
    return rows


def load_mnist_stream(*args: Any, **kwargs: Any):
    raise RuntimeError(
        "dataset download requires network egress, unavailable in this "
        "environment; load a local copy with parse_svm_file"
    )
