"""Share of the escalated rows (UNRESOLVED at the first iteration cap)
that the program settled on the device, in its deep-cap K2 launch ahead
of the host worklist: the summed ``device`` of its ``escalation`` spans
over their summed ``rows`` (``repro_torch.obs``).  Nothing to read where
no row escalated, or where the program records no spans or no ``device``
attribute (a program without the device tier)."""


def read(run):
    try:
        from repro_torch import obs
    except ImportError:                 # a program without the recorder
        return None
    esc = obs.summary().get("escalation")
    if not esc or "device" not in esc["attrs"] or not esc["attrs"]["rows"]:
        return None
    return esc["attrs"]["device"] / esc["attrs"]["rows"]
