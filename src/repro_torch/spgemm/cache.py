"""Sparsity-pattern fingerprinting.

Only :func:`pattern_digest`, which names a plan's pattern in its report.
The plan cache itself (memory LRU and disk tier) is not ported yet, so
``spgemm_plan`` builds on every call.
"""
from __future__ import annotations

import hashlib
from typing import Tuple

import numpy as np

__all__ = ["pattern_digest"]


def pattern_digest(*arrays: np.ndarray, meta: Tuple = ()) -> str:
    """Stable hex digest of a sparsity pattern (index arrays + shape meta).

    Values are deliberately excluded — two inputs with the same nonzero
    support but different values hash identically, which is exactly the
    plan-reuse contract.
    """
    h = hashlib.blake2b(digest_size=16)
    h.update(repr(meta).encode())
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()
