"""Exclusive device milliseconds a render pass (an SPPM iteration) spends
in the lights layer (`lights.area_le`, `env_le`, `sample_li`,
`pdf_li_area`, `pdf_li_infinite`, `lighttracer.sample_le`,
`distrib.select_light`, `selection_pdf`): the kernels launched inside
its spans and inside no child span, in the fullest unit of the layer
trace (benchmark/layers.py)."""

from benchmark import layers


def read(trace):
    return layers.ms_per_pass(trace, "lights")
