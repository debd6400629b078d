"""Peak device memory of the traced gradient steps in GiB: read as
peak_mem_gib.render reads the passes'."""

from benchmark.profile import peak_gib as read  # noqa: F401
