"""Milliseconds a job spends in the bounds engine: the summed duration of
the program's ``local_bounds`` (pair bounds) and ``bounds`` (channel
bounds) spans over the window's ``construct`` spans, one an advisor
(``repro_torch.obs``).  Nothing to read where no advisor was built, or
where the program records neither span."""

SPANS = ("local_bounds", "bounds")


def read(run):
    try:
        from repro_torch import obs
    except ImportError:                 # a program without the recorder
        return None
    spans = obs.summary()
    jobs = spans.get("construct", {}).get("count", 0)
    if not jobs or not any(k in spans for k in SPANS):
        return None
    return 1e3 * sum(spans[k]["total_s"] for k in SPANS if k in spans) / jobs
