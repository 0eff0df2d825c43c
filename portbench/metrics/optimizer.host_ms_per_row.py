"""Milliseconds the optimizers' own host work takes a proposed row: the
summed duration of the program's ``optimizer.step`` spans (each step of
a search's generator, evaluation excluded) over the rows of the
requests they yielded (``repro_torch.obs``).  Nothing to read where no
search stepped, or where the program records no spans."""


def read(run):
    try:
        from repro_torch import obs
    except ImportError:                 # a program without the recorder
        return None
    step = obs.summary().get("optimizer.step")
    rows = step["attrs"].get("rows", 0) if step else 0
    return 1e3 * step["total_s"] / rows if rows else None
