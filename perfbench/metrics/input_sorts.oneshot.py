"""Operands per completed request that the plan's inputs stage sorted into
canonical order: the count ``sorts`` of the program's span
``spgemm.plan.inputs`` (0, 1 or 2 a plan; an operand already canonical, or
the second side of A·A, takes no sort). A program whose inputs span counts
no sorts gives nothing."""
from perfbench.spans import per_request


def read(run):
    return per_request(run, "spgemm.plan.inputs", count="sorts", scale=1)
