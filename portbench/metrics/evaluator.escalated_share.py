"""Share of evaluated rows that the rung cascade and the iteration cap left
to the worklist arbiter: ``BatchStats.n_fallbacks / n_configs`` summed
over the window's jobs."""


def read(run):
    stats = run.counters.get("batch_stats")
    rows = sum(s.n_configs for s in stats or ())
    return sum(s.n_fallbacks for s in stats) / rows if rows else None
