"""Host time per completed request of the executor's build (scatter inverses,
the schedule's runs and the gather map staged on the device): the program's span
``spgemm.plan.stage``."""
from perfbench.spans import per_request


def read(run):
    return per_request(run, "spgemm.plan.stage")
