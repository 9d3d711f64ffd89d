"""Median time the requests that completed in the window (before any
trace) waited in the scheduler's admission queue (submit to admit), from
the batcher's completed-request samples (``ContinuousBatcher.slo_recent``,
the source of the server's ``gen_queue_wait_ms`` timers)."""

from benchmark import stats


def read(run):
    n = run.until["stats"]["slo_samples"] - run.before["stats"]["slo_samples"]
    if n <= 0:
        return None
    waits = [s[0] * 1e3 for s in run.until["slo"][-n:]]
    return stats.percentile(waits, 50)
