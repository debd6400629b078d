"""Exclusive device milliseconds a render pass (an SPPM iteration) spends
in the camera layer (`path.camera_rays_for_pixels` and
`camera_ray_differentials`; the sampler's calls they make are the
sampler's): the kernels launched inside its spans and inside no child
span, in the fullest unit of the layer trace (benchmark/layers.py)."""

from benchmark import layers


def read(trace):
    return layers.ms_per_pass(trace, "camera")
