"""Host time per completed request of the BCSV and BCSR conversion: the
program's span ``spgemm.plan.convert``."""
from perfbench.spans import per_request


def read(run):
    return per_request(run, "spgemm.plan.convert")
