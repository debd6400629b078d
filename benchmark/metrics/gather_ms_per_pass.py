"""Device milliseconds an SPPM iteration spends in the kernels launched
inside `integrators/sppm.py::gather` (the dense photon gather: the
distance test of every photon against every visible point and the
deposit), over the iterations of the fullest traced job."""

from benchmark import profile


def read(trace):
    s = profile.span_seconds(trace["fullest"], "gather")
    return None if s is None else s * 1e3 / trace["per_unit"]
