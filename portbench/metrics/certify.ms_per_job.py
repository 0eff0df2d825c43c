"""Milliseconds a deadlock certification takes: the summed duration of
the program's ``certify`` spans over their count, one an advisor that
certifies (``repro_torch.obs``).  Nothing to read where nothing was
certified, or where the program records no such span."""


def read(run):
    try:
        from repro_torch import obs
    except ImportError:                 # a program without the recorder
        return None
    cert = obs.summary().get("certify")
    return 1e3 * cert["total_s"] / cert["count"] if cert else None
