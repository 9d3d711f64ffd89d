"""Real rows per micro-batch flush in the window
(``seldon_engine_microbatch_rows`` over ``_flushes``)."""


def read(run):
    flushes = run.until["flushes"] - run.before["flushes"]
    if flushes <= 0:
        return None
    return (run.until["rows"] - run.before["rows"]) / flushes
