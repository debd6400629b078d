"""The device's idle share of a traced gradient step, in percent: read
as device_idle_pct.render reads a pass."""

from benchmark.profile import idle_pct as read  # noqa: F401
