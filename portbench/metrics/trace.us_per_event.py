"""Microseconds of the front end's trace a raw event: the summed duration
of the program's ``construct.trace`` spans over their summed ``events``
attribute (``repro_torch.obs``).  Nothing to read where no advisor was
built, or where the program's span carries no ``events``."""

SPAN = "construct.trace"


def read(run):
    try:
        from repro_torch import obs
    except ImportError:                 # a program without the recorder
        return None
    span = obs.summary().get(SPAN)
    if not span or not span["attrs"].get("events"):
        return None
    return 1e6 * span["total_s"] / span["attrs"]["events"]
