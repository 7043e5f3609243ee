"""Host time per completed request of the assembly map: the program's span
``spgemm.plan.assembly``."""
from perfbench.spans import per_request


def read(run):
    return per_request(run, "spgemm.plan.assembly")
