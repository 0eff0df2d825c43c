"""The share of K2 and K1 launches whose depth operands the program built
with its depth-operand kernel on the card: the summed ``device_operands``
attribute of the program's ``launch.k2`` and ``launch.k1`` spans over
their number (``repro_torch.obs``).  Nothing to read where neither kernel
was launched, or where the program sets no such attribute."""

LAUNCHES = ("launch.k2", "launch.k1")


def read(run):
    try:
        from repro_torch import obs
    except ImportError:                 # a program without the recorder
        return None
    spans = obs.summary()
    got = [spans[k] for k in LAUNCHES if k in spans]
    n = sum(s["count"] for s in got)
    if not n or not any("device_operands" in s["attrs"] for s in got):
        return None
    return sum(s["attrs"].get("device_operands", 0) for s in got) / n
