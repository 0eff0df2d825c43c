"""K1's share of its roofline over the window, in percent: the summed
bound of every K1 launch (certificate slots counted;
``portbench/roofline.py``) over the summed device time of K1's trace
entries.  Nothing to read where K1 did
not run or the trace holds no K1 entry."""

from portbench import probe, roofline

KERNEL = "k1"


def read(run):
    if run.kernels is None or run.profile is None:
        return None
    n, bound = run.kernels.bounds().get(KERNEL, (0, 0.0))
    if not n:
        return None
    return roofline.share_percent(
        bound, probe.kernel_device_s(run.profile["by_op"], KERNEL))
