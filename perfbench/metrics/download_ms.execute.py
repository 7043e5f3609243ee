"""Host time per completed request of C's copy to the host (the wait for the
device plus the copy): the program's span ``spgemm.execute.download``."""
from perfbench.spans import per_request


def read(run):
    return per_request(run, "spgemm.execute.download")
