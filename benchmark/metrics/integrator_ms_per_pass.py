"""Exclusive device milliseconds of a render pass's own span (an SPPM
iteration's): the estimator's arithmetic, trace_pair's concatenations,
roulette and the SPPM update, outside every layer it calls, in the
fullest unit of the layer trace (benchmark/layers.py)."""

from benchmark import layers


def read(trace):
    return layers.ms_per_pass(trace, "pass")
