"""Device kernels launched in one traced gradient step (forward,
autograd's backward and the Adam update), from torch.profiler's trace of
the fullest traced step; copies and fills are not launches."""


def read(trace):
    return float(trace["fullest"]["launches"])
