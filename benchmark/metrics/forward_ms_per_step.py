"""Device milliseconds of a gradient step's forward (`make_train_step`'s
`forward` span and every layer it calls: the render of the loss under
autograd), in the fullest step of the layer trace (benchmark/layers.py)."""

from benchmark import layers


def read(trace):
    return layers.inclusive_ms(trace, "forward")
