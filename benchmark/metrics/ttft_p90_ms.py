"""90th percentile, over every request sent in the window, of the time
from when it was due to its first streamed token (a failed request is a
sample at infinity)."""

from benchmark import stats
from benchmark.readings import finite


def read(run):
    return finite(stats.percentile(stats.ttfts_ms(run.records), 90))
