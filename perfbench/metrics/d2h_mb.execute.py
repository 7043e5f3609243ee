"""MB of C's values copied to the host per completed request: the ``bytes``
of the program's span ``spgemm.execute.download``."""
from perfbench.spans import per_request


def read(run):
    return per_request(run, "spgemm.execute.download", count="bytes", scale=1e-6)
