"""Host time per completed request of the values' copy to the device: the
program's span ``spgemm.execute.upload``."""
from perfbench.spans import per_request


def read(run):
    return per_request(run, "spgemm.execute.upload")
