"""Share of a job cell's traced window in which no operation ran on the
device: 1 - busy / window, busy being the union of the device activity
``torch.profiler`` recorded."""


def read(run):
    p = run.profile
    if run.device != "cuda" or p is None or not p["window_s"]:
        return None
    return 1.0 - p["busy_s"] / p["window_s"]
