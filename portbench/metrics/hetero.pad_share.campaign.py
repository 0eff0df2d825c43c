"""Share of the campaigns' cross-design dispatch rows that are bucket
padding: ``n_pad_rows / (n_rows + n_pad_rows)`` of their ``HeteroStats``
summed over the window."""


def read(run):
    stats = run.counters.get("hetero_stats")
    pad = sum(s.n_pad_rows for s in stats or ())
    total = pad + sum(s.n_rows for s in stats or ())
    return pad / total if total else None
