"""Host time per completed request of the values' host rebind (numpy
conversion and the host scatter): the program's span ``spgemm.execute.rebind``."""
from perfbench.spans import per_request


def read(run):
    return per_request(run, "spgemm.execute.rebind")
