"""Rows the optimizers hand the evaluator a call: ``BatchStats.n_configs
/ n_calls`` summed over the window's jobs."""


def read(run):
    stats = run.counters.get("batch_stats")
    calls = sum(s.n_calls for s in stats or ())
    return sum(s.n_configs for s in stats) / calls if calls else None
