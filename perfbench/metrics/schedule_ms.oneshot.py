"""Host time per completed request of the block-Gustavson schedule: the
program's span ``spgemm.plan.schedule``."""
from perfbench.spans import per_request


def read(run):
    return per_request(run, "spgemm.plan.schedule")
