"""Device milliseconds a render pass spends in the kernels launched
inside calls of `pbrt_tpu_torch.ops.intersect.intersect` (the dense
K1/K2 route, the quadric pre-test, the coherence sort and every other
kernel the call launches)."""

from benchmark import profile


def read(trace):
    s = profile.span_seconds(trace["fullest"], "intersect")
    return None if s is None else s * 1e3 / trace["per_unit"]
