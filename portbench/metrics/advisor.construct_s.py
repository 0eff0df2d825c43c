"""Mean seconds of a job's ``FifoAdvisor`` (or ``Campaign``) constructor,
on the host clock after a synchronise: the benchmark's own span."""


def read(run):
    xs = run.counters.get("construct_s")
    return sum(xs) / len(xs) if xs else None
