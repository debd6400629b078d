"""The intersect calls' least time over their device time, in percent.

The least time is bound by bytes at the H100's 3.35 TB/s, counted from
the calls' inputs alone: per call, each lane's origin, direction and
tmax read once (28 B) and its t and primitive written once (8 B), and
the scene's triangles (36 B each: three vertices) and quadric records
(64 B each: a 3x4 world-to-object matrix and 4 parameters) read once.
The count is the same whatever implements the intersect."""

from benchmark import peaks, profile

LANE_BYTES = 36
TRIANGLE_BYTES = 36
QUADRIC_BYTES = 64


def read(trace):
    p = trace["fullest"]
    s = profile.span_seconds(p, "intersect")
    calls = p["sizes"].get("intersect", [])
    if not s or not calls:
        return None
    counts = trace["state"].counts
    per_call = (counts["triangles"] * TRIANGLE_BYTES
                + counts["quadrics"] * QUADRIC_BYTES)
    nbytes = sum(LANE_BYTES * b + per_call for b in calls)
    return 100.0 * nbytes / peaks.HBM_BYTES_PER_S / s
