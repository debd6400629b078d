"""The sampler seeds a run draws from its --seed (32-bit words), shared
by the drivers and the control."""


def job_seed(seed, j):
    """The sampler seed of a render run's j-th job (j = -1: warm-up)."""
    return (int(seed) * 0x9E3779B1 + (j + 1) * 0x85EBCA77) % (1 << 32)


def grad_seed(seed):
    """The sampler seed of a gradient run's steps."""
    return job_seed(seed, 0)
