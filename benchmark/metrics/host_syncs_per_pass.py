"""Waits of the host on the device in one traced render pass: the
runtime's stream, device and event synchronisations and blocking copies
the profiler saw inside the pass (a tensor's item() or a D2H copy waits
through one of them)."""


def read(trace):
    return float(trace["fullest"]["syncs"]) / trace["per_unit"]
