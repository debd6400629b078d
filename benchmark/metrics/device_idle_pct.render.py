"""The device's idle share of a traced unit, in percent: 1 - the summed
time of its device operations / the unit's wall time (host clock around
the unit and its final synchronisation), over the fullest traced unit,
as `tools/profile_pass.py` computes it."""

from benchmark.profile import idle_pct as read  # noqa: F401
