"""Milliseconds of host time a row escalated to the worklist arbiter: the
summed duration of the program's ``escalation`` spans over their summed
``rows`` (``repro_torch.obs``, recorded while the traced window's
profiler runs).  Nothing to read where no row escalated, or where the
program records no spans."""


def read(run):
    try:
        from repro_torch import obs
    except ImportError:                 # a program without the recorder
        return None
    esc = obs.summary().get("escalation")
    rows = esc["attrs"].get("rows", 0) if esc else 0
    return 1e3 * esc["total_s"] / rows if rows else None
