"""Rows answered inside the window, over the window's length."""

from benchmark import stats


def read(run):
    rows = run.plan.n_rows * len(stats.answered_in(run.records, run.t0, run.t1))
    return rows / run.seconds or None
