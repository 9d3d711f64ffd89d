"""95th percentile of the client's latency, from when each request was
due to its answer, over the requests the served path answered in the
window. Above the knee the engine sheds what it cannot take
(``refused_pct`` beside this counts those); this is the wait of the rest:
read, not judged."""

from benchmark import stats


def read(run):
    answered = [r for r in run.records if not r.get("error")]
    return stats.percentile(stats.latencies_ms(answered), 95)
