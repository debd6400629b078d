"""Device kernels launched in one traced render pass (an SPPM iteration
counts as a pass), read from torch.profiler's trace of the fullest
traced pass; copies and fills are not launches."""


def read(trace):
    return float(trace["fullest"]["launches"]) / trace["per_unit"]
