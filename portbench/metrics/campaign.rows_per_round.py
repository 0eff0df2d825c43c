"""Real rows a cross-design dispatch of the campaigns: ``HeteroStats
.n_rows / n_dispatches`` summed over the window's campaigns."""


def read(run):
    stats = run.counters.get("hetero_stats")
    n = sum(s.n_dispatches for s in stats or ())
    return sum(s.n_rows for s in stats) / n if n else None
