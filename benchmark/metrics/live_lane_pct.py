"""The share of the wavefront's lanes that carried a live ray: 100 x
the live closest-hit and candidate shadow tests a one-pass job counts
(`path.render(stats=)`) over the lanes its intersect calls carried (the
intersect span's lane count), in one counted unit (benchmark/layers.py).
Every elementwise kernel of a bounce runs over all lanes, so 100 - this
is the share a compaction of dead lanes could take away."""

from benchmark import layers


def read(trace):
    return layers.live_lane_pct(trace)
