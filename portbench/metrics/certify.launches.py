"""Evaluator calls a deadlock certification makes, the probes the cache
answered left out: the summed ``launches`` of the program's ``certify``
spans over their count (``repro_torch.obs``).  One a probe where every
probe is a call of its own; fewer where one call carries several levels
of a FIFO's bisection.  Nothing to read where nothing was certified, or
where the program's span carries no such attribute."""


def read(run):
    try:
        from repro_torch import obs
    except ImportError:                 # a program without the recorder
        return None
    cert = obs.summary().get("certify")
    if not cert or "launches" not in cert["attrs"]:
        return None
    return cert["attrs"]["launches"] / cert["count"]
