"""Host time per completed request of enqueueing the bind gather, K1 and the
assembly gather: the program's span ``spgemm.execute.launch``."""
from perfbench.spans import per_request


def read(run):
    return per_request(run, "spgemm.execute.launch")
