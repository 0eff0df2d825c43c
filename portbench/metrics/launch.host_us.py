"""Microseconds of host time a kernel launch takes, waiting for the device
left out: the summed duration of the program's ``launch.k2``,
``launch.k1`` and ``launch.k2_hetero`` spans less their
``launch.readback`` children (the copy back, which waits), over the
number of launches (``repro_torch.obs``).  Nothing to read where no
kernel was launched, or where the program records no spans."""

LAUNCHES = ("launch.k2", "launch.k1", "launch.k2_hetero")


def read(run):
    try:
        from repro_torch import obs
    except ImportError:                 # a program without the recorder
        return None
    spans = obs.summary()
    n = sum(spans[k]["count"] for k in LAUNCHES if k in spans)
    if not n:
        return None
    host = sum(spans[k]["total_s"] for k in LAUNCHES if k in spans) \
        - spans.get("launch.readback", {}).get("total_s", 0.0)
    return 1e6 * host / n
