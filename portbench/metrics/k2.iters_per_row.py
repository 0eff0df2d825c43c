"""Fixpoint iterations K2 ran a launched row (padding rows included): the
summed ``iters`` of the program's ``launch.k2`` and ``launch.k2_hetero``
spans over their summed ``rows`` (``repro_torch.obs``; the output's
iteration lane, copied back with the results).  Nothing to read where K2
did not run, or where the program records no spans."""

LAUNCHES = ("launch.k2", "launch.k2_hetero")


def read(run):
    try:
        from repro_torch import obs
    except ImportError:                 # a program without the recorder
        return None
    spans = obs.summary()
    attrs = [spans[k]["attrs"] for k in LAUNCHES if k in spans]
    rows = sum(a.get("rows", 0) for a in attrs)
    return sum(a.get("iters", 0) for a in attrs) / rows if rows else None
