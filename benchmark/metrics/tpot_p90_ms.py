"""90th percentile, over every request sent in the window that asked for
two tokens or more, of (last token - first token) / (tokens - 1) (a
failed request is a sample at infinity)."""

from benchmark import stats
from benchmark.readings import finite


def read(run):
    return finite(stats.percentile(stats.tpots_ms(run.records), 90))
