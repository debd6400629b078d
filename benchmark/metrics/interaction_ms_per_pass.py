"""Exclusive device milliseconds a render pass (an SPPM iteration) spends
in the interaction layer (`ops/intersect.py::make_hit`: the winners' re-
solve, normals, uv and differentials): the kernels launched inside its
spans and inside no child span, in the fullest unit of the layer trace
(benchmark/layers.py)."""

from benchmark import layers


def read(trace):
    return layers.ms_per_pass(trace, "interaction")
