"""Exclusive device milliseconds a render pass spends in the film layer
(`film.make_film`, `film.add_samples`): the kernels launched inside its
spans and inside no child span, in the fullest unit of the layer trace
(benchmark/layers.py).  Not read in an SPPM cell, whose film is written
after a job's iterations, outside them."""

from benchmark import layers


def read(trace):
    return layers.ms_per_pass(trace, "film")
