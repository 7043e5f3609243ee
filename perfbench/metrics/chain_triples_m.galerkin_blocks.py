"""Millions of block triples a chain computed per completed request: the
count ``triples`` of the program's span ``spgemm.chain``, summed over its
stages (each triple one product of two tiles; ``pairs`` is triples times
bm·bk·bn). A program whose chain span counts no triples gives nothing."""
from perfbench.spans import per_request


def read(run):
    return per_request(run, "spgemm.chain", count="triples", scale=1e-6)
