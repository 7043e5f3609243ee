"""MB of values copied host to device per completed request: the ``bytes``
of the program's span ``spgemm.execute.upload``. 0 where A's values, handed
over on the card, stay there; a program without that span gives
nothing."""
from perfbench.spans import per_request


def read(run):
    return per_request(run, "spgemm.execute.upload", count="bytes", scale=1e-6)
