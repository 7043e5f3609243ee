"""Products returned to the host per second, over the whole window of a
closed loop: from the first request's start to the last one's end."""


def read(run):
    if run.window_s <= 0:
        return None
    return sum(1 for r in run.requests if r.ok) / run.window_s
