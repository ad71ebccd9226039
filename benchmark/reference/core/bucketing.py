# Frozen copy of gapro_tpu_torch/core/bucketing.py; it does not follow later changes
# to the port.
"""Static-shape bucketing (numpy copy of ``gapro_tpu/core/bucketing.py``).

Buffers are padded up to a bucket so that a handful of shapes cover a whole
dataset; validity is carried by masks and counts, never by dynamic shapes.
"""

from __future__ import annotations


def next_bucket(n: int, min_size: int = 128, granularity: int = 2) -> int:
    """Smallest bucket >= n: ``{1, 1.5} * 2^k`` for ``granularity == 2``
    (at most 50% padding), pure powers of two for ``granularity == 1``."""
    n = max(int(n), 1)
    if n <= min_size:
        return min_size
    p = 1 << (n - 1).bit_length()
    if granularity >= 2:
        candidate = (p // 4) * 3
        if candidate >= n and candidate >= min_size:
            return candidate
    return p
