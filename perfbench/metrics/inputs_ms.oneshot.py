"""Host time per completed request of the plan's inputs (canonical COO of
both operands, dtypes, the pattern digest): the program's span ``spgemm.plan.inputs``."""
from perfbench.spans import per_request


def read(run):
    return per_request(run, "spgemm.plan.inputs")
