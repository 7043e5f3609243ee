"""Device time of the device-to-host copies per completed request, from
the device trace."""


def read(run):
    done = sum(1 for r in run.requests if r.ok)
    if run.trace is None or not done:
        return None
    s = run.trace.total(match="Memcpy DtoH")
    return 1e3 * s / done if s > 0 else None
