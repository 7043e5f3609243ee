"""Quickstart: the paper's SpGEMM in five steps, on the host models alone
(the CSV format, the FPGA-kernel simulator, the Gustavson oracle); it
touches no device and launches no kernel. Its printed numbers equal the
JAX package's ``examples/quickstart.py`` line by line.

    PYTHONPATH=src python examples_torch/quickstart.py
"""
import numpy as np

from repro_torch.core.buffering import omar
from repro_torch.core.gustavson import FSpGEMMSimulator, spgemm_gustavson
from repro_torch.core.tuning import ARRIA10_GX, derive_fpga_params
from repro_torch.sparse.convert import to_csv
from repro_torch.sparse.random import suite_matrix


def main():
    # 1. A sparse matrix with the published poisson3Da profile (Table 4).
    a = suite_matrix("poisson3Da", scale=0.02)
    print(f"matrix: {a}")

    # 2. Derive the paper's architectural parameters for Arria 10 GX.
    sw, num_pe = derive_fpga_params(ARRIA10_GX)
    print(f"Sec 4.2.4 optimum: SW={sw}, NUM_PE={num_pe}")

    # 3. Host pre-processing: convert to the CSV format (Sec. 3).
    a_csv = to_csv(a, num_pe)
    a_csv.validate()
    print(f"CSV vectors: {a_csv.num_vectors()}  OMAR: {omar(a, num_pe):.1f}%")

    # 4. Run the FPGA-kernel simulator (Sec. 4.2 + Algorithm 1).
    c, stats = FSpGEMMSimulator(num_pe, sw).run(a_csv, a)
    print(f"C = A @ A: nnz={c.nnz}, kernel cycles={stats.cycles}, "
          f"B-row fetches={stats.b_row_fetches} (naive would be {a.nnz})")

    # 5. Check against the vectorized Gustavson oracle.
    ref = spgemm_gustavson(a, a)
    err = np.abs(c.todense() - ref.todense()).max()
    print(f"max |err| vs oracle: {err:.2e}")
    assert err < 1e-3
    print("OK")


if __name__ == "__main__":
    main()
