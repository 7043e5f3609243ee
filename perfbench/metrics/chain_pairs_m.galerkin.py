"""Millions of scalar products a chain computed per completed request: the
count ``pairs`` of the program's span ``spgemm.chain``, summed over its
stages. At element granularity it is the Galerkin product's pairs, R·A's
and (R·A)·P's, with no block fill; a program without that span gives
nothing."""
from perfbench.spans import per_request


def read(run):
    return per_request(run, "spgemm.chain", count="pairs", scale=1e-6)
