"""Share of the prompt tokens of the window's answered requests that the
prefix cache served (the sum of the responses' ``cache_hit_tokens`` over
the prompt tokens sent), in %."""


def read(run):
    done = [r for r in run.records if not r.get("error") and r.get("tokens")]
    sent = sum(int(run.plan.prompt_len[r["i"]]) for r in done)
    if not sent:
        return None
    return 100.0 * sum(int(r.get("hit") or 0) for r in done) / sent
