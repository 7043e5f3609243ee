"""Host time per completed request of wrapping C's values in the CSR
structure: the program's span ``spgemm.execute.wrap``."""
from perfbench.spans import per_request


def read(run):
    return per_request(run, "spgemm.execute.wrap")
