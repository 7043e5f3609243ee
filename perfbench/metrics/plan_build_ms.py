"""Mean host-clock time of the ``spgemm_plan`` calls in the window (the
symbolic phase of each request of a one-call product)."""


def read(run):
    spans = run.spans.get("spgemm_plan")
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
