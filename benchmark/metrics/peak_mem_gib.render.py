"""Peak device memory of the traced units in GiB: torch's
max_memory_allocated after its peak was reset at the window's start."""

from benchmark.profile import peak_gib as read  # noqa: F401
