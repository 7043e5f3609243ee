"""Millions of scalar products the kernel computed per completed request:
the count ``pairs`` of the program's span ``spgemm.execute.launch``. At
element granularity it is the product's pairs A[i,k]·A[k,j], with no block
fill; a program whose launch span counts no pairs gives nothing."""
from perfbench.spans import per_request


def read(run):
    return per_request(run, "spgemm.execute.launch", count="pairs", scale=1e-6)
