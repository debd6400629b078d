"""Device milliseconds of the kernels launched inside a step's call of
`torch.autograd.grad` (autograd's engine running the backward), in the
fullest traced step."""

from benchmark import profile


def read(trace):
    s = profile.span_seconds(trace["fullest"], "backward")
    return None if s is None else s * 1e3
