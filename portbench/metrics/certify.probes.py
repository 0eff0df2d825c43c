"""Feasibility probes a deadlock certification evaluates (cache misses):
the summed ``probes`` of the program's ``certify`` spans over their count
(``repro_torch.obs``).  Seeded by the channel bounds, a certification
takes about 2; unseeded, one of the flowgnn_pna streams takes over a
hundred.  Nothing to read where nothing was certified, or where the
program records no such span."""


def read(run):
    try:
        from repro_torch import obs
    except ImportError:                 # a program without the recorder
        return None
    cert = obs.summary().get("certify")
    if not cert or "probes" not in cert["attrs"]:
        return None
    return cert["attrs"]["probes"] / cert["count"]
