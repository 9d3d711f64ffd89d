"""Share of the requests sent in the window that the engine shed before
work (429 / RESOURCE_EXHAUSTED past ``seldon.io/max-inflight``), in %.
Above the knee this is the offered load the served path could not take."""


def read(run):
    if not run.records:
        return None
    return 100.0 * sum(1 for r in run.records if r.get("refused")) / len(run.records)
