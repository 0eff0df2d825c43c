"""Share of the traced window the program spent escalating rows to the
worklist arbiter: the summed duration of its ``escalation`` spans
(``repro_torch.obs``) over the window; 0 where no row escalated.
Nothing to read where the program records no spans."""


def read(run):
    try:
        from repro_torch import obs
    except ImportError:                 # a program without the recorder
        return None
    spans = obs.summary()
    if run.profile is None or not run.profile["window_s"] or not spans:
        return None
    esc = spans.get("escalation")
    return (esc["total_s"] if esc else 0.0) / run.profile["window_s"]
