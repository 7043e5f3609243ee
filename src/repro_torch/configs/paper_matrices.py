"""The paper's evaluation set (Table 4) as a config, re-exported from
``core/perfmodel.py`` (the names) and ``sparse/random.py`` (the specs and
their synthetic generators)."""
from repro_torch.core.perfmodel import PAPER_MATRICES
from repro_torch.sparse.random import SUITE, suite_matrix

__all__ = ["PAPER_MATRICES", "SUITE", "suite_matrix"]
