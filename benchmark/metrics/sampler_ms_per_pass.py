"""Exclusive device milliseconds a render pass (an SPPM iteration) spends
in the sampler layer (`samplers.sample_dim`: the Owen-scrambled Sobol'
hashing in int64 and every other sampler's): the kernels launched inside
its spans and inside no child span, in the fullest unit of the layer
trace (benchmark/layers.py)."""

from benchmark import layers


def read(trace):
    return layers.ms_per_pass(trace, "sampler")
