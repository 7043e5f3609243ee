"""Share of completed requests whose plan built its block assembly map on
the card: the count ``on_device`` of the program's span
``spgemm.plan.assembly`` (1 where a CUDA plan built the map on its device,
0 where the host built it) per completed request. A program whose assembly
span counts nothing gives nothing."""
from perfbench.spans import per_request


def read(run):
    return per_request(run, "spgemm.plan.assembly", count="on_device", scale=1)
