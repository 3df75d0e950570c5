"""``setup_s``: seconds from the process's start to the first timed call (kernel build, weights,
traffic, the program's featurization and estimator, and the warm-up of every call of the cycle)."""


def read(run):
    return run.setup_s
