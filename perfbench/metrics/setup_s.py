"""Set-up: from the process's start to the first timed request (imports,
the kernels' build on a checkout's first run, inputs, the program's set-up
and warm-up)."""


def read(run):
    return run.setup_s
