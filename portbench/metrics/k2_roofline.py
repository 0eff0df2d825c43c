"""K2's share of its roofline over the window, in percent: the summed
bound of every K2 launch (both modes; ``portbench/roofline.py``) over the
summed device time of K2's trace entries.  Nothing to read where K2 did
not run or the trace holds no K2 entry."""

from portbench import probe, roofline

KERNEL = "k2"


def read(run):
    if run.kernels is None or run.profile is None:
        return None
    n, bound = run.kernels.bounds().get(KERNEL, (0, 0.0))
    if not n:
        return None
    return roofline.share_percent(
        bound, probe.kernel_device_s(run.profile["by_op"], KERNEL))
