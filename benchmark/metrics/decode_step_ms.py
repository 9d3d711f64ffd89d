"""Device time of one decode step in the window: the device-time
ledger's seconds of the decode bursts (graph replays timed with CUDA
events; ``serving/profiler.py``, on in the traced run) over the decode
steps dispatched."""

from benchmark.readings import DECODE_KINDS


def read(run):
    a, b = run.before.get("ledger"), run.until.get("ledger")
    if a is None or b is None:
        return None
    secs = sum(v[0] - a.get(k, (0.0,))[0] for k, v in b.items() if k[0] in DECODE_KINDS)
    steps = run.until["stats"]["steps"] - run.before["stats"]["steps"]
    if steps <= 0 or secs <= 0:
        return None
    return 1e3 * secs / steps
