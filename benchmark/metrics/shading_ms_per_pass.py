"""Exclusive device milliseconds a render pass (an SPPM iteration) spends
in the shading layer (`bsdf.gather_materials`, `bump_shading_normal`,
`shading_frame`, `eval_f`, `sample_f`, `pdf_f`): the kernels launched
inside its spans and inside no child span, in the fullest unit of the
layer trace (benchmark/layers.py)."""

from benchmark import layers


def read(trace):
    return layers.ms_per_pass(trace, "shading")
