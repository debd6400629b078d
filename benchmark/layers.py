"""Device time by the program's own layer spans, for the readers of the
layer metrics.

The program opens a `torch.profiler.record_function` range named
"pbrt.<layer>" at each of its layer boundaries while its spans are on
(`pbrt_tpu_torch.utils.stats.tracing`): job, pass, camera, sampler,
intersect, interaction, shading, lights, film, gather, step, forward,
backward.  A kernel belongs to the innermost layer whose range holds its
launch (matched by its CUPTI correlation id, as `profile.py` matches
it), so a layer's exclusive time is that of the kernels launched inside
it and inside none of its children.  Only the host's main thread opens
layer ranges; a kernel that autograd's engine launches from its own
thread falls in the range the main thread waits in (`backward`).

The layer trace is made the first time a reader asks for it, after the
traced run's own profiled units, which run with the spans off, have been
read: units of the cell's work (a one-pass job, an SPPM job or a step,
its film not kept for the check), each under torch.profiler with the
spans on, until one holds as many kernels as the fullest spans-off unit
(at most as many units as those), and the unit with the most kernels
read.  `live_lane_pct` adds one counted unit outside the profiler.  A
program without spans gives None to every reader here.
"""

from __future__ import annotations

import sys
import time

import torch
from torch.autograd import DeviceType

from benchmark import profile
from benchmark.seeds import job_seed

PREFIX = "pbrt."
# a layer trace whose launches reach this share of the fullest spans-off
# unit's lost none of its kernels, and no further unit is traced: a trace
# that lost kernels falls ~1% short (146 of a step's 19,029 on the H100),
# while a unit's own launches vary by a few from seed to seed
COMPLETE = 0.999
# the counters `path.render(stats=)` fills for the live tests
LIVE_TESTS = ("Intersections/Regular ray intersection tests",
              "Intersections/Shadow ray intersection tests")


def innermost(times, ranges):
    """For each time of `times`, the name of the innermost of `ranges`
    ((start, end, name), nested as one thread's calls nest) that holds
    it, None where none does."""
    ranges = sorted(ranges, key=lambda r: (r[0], -r[1]))
    order = sorted(range(len(times)), key=lambda i: times[i])
    out = [None] * len(times)
    stack = []
    j = 0
    for i in order:
        t = times[i]
        while j < len(ranges) and ranges[j][0] <= t:
            while stack and stack[-1][1] < ranges[j][0]:
                stack.pop()
            stack.append(ranges[j])
            j += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[i] = stack[-1][2] if stack else None
    return out


def read(prof, wall_s):
    """One traced unit: `profile.py`'s kernel rows and counts (the layer
    ranges' device-side annotations are not kernels there), with the
    program's layer ranges and the start of each host synchronisation
    inside the unit."""
    p = profile._read(prof, wall_s)
    cpu = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    p["layers"] = [(e.time_range.start, e.time_range.end,
                    e.name[len(PREFIX):]) for e in cpu
                   if e.name.startswith(PREFIX)]
    unit = next(((e.time_range.start, e.time_range.end) for e in cpu
                 if e.name == profile.UNIT), None)
    p["sync_at"] = [e.time_range.start for e in cpu
                    if e.name in profile.SYNC_CALLS and unit is not None
                    and unit[0] <= e.time_range.start <= unit[1]]
    return p


def split(p):
    """(exclusive device seconds by layer, None for the kernels launched
    outside every layer; the kernel rows with their layer)."""
    rows = [r for r in p["kernels"] if r["launched"] is not None]
    layer_of = innermost([r["launched"] for r in rows], p["layers"])
    seconds = {}
    for r, layer in zip(rows, layer_of):
        seconds[layer] = seconds.get(layer, 0.0) + r["dur_s"]
    return seconds, list(zip(rows, layer_of))


def inclusive_seconds(p, layer):
    """Device seconds of the kernels launched inside any range of
    `layer`, its children's included; None if it opened no range."""
    ranges = [(a, b) for a, b, n in p["layers"] if n == layer]
    return profile.span_seconds(dict(p, spans={layer: ranges}), layer)


def idle_gaps(rows):
    """The idle gaps before each kernel summed by the layer the host was
    in at its launch and the op that launched it; the ten longest."""
    rows = sorted(rows, key=lambda rl: rl[0]["start"])
    gaps = {}
    for (a, _), (b, layer) in zip(rows, rows[1:]):
        g = (b["start"] - a["end"]) * 1e-6
        if g > 0:
            label = f"{layer or 'outside'}: {b['op'] or 'host'}"
            gaps[label] = gaps.get(label, 0.0) + g
    return sorted(gaps.items(), key=lambda x: -x[1])[:10]


def _spans_on():
    """The program's `tracing`, None on a program without spans."""
    try:
        from pbrt_tpu_torch.utils.stats import tracing
    except ImportError:
        return None
    return tracing


def _unit(driver, st):
    """One unit of the cell's work through its driver; a render unit's
    film is not kept for the check."""
    kept = getattr(st, "results", None)
    n = len(kept) if kept is not None else 0
    driver.unit(st)
    if kept is not None:
        del kept[n:]


def _fmt(d, scale=1.0, digits=3):
    return ", ".join(f"{k or 'outside'} {v * scale:.{digits}f}"
                     for k, v in sorted(d.items(), key=lambda x: -x[1]))


def traced(trace):
    """The layer trace of the run (module docstring), made once and kept
    in `trace`; None on a program without spans."""
    if "layers" in trace:
        return trace["layers"]
    trace["layers"] = None
    tracing = _spans_on()
    if tracing is None:
        return None
    t_start = time.perf_counter()
    st = trace["state"]
    driver = sys.modules[type(st).__module__]
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    profiles = []
    with tracing():
        for _ in range(trace["units"]):
            with torch.profiler.profile(activities=acts) as prof:
                t0 = time.perf_counter()
                with torch.profiler.record_function(profile.UNIT):
                    _unit(driver, st)
                if st.device.type == "cuda":
                    torch.cuda.synchronize(st.device)
                wall = time.perf_counter() - t0
            profiles.append(read(prof, wall))
            if profiles[-1]["launches"] >= (COMPLETE
                                            * trace["fullest"]["launches"]):
                break
    best = max(profiles, key=lambda p: p["launches"])
    seconds, rows = split(best)
    inside = sum(v for k, v in seconds.items() if k is not None)
    syncs = {}
    for layer in innermost(best["sync_at"], best["layers"]):
        syncs[layer] = syncs.get(layer, 0) + 1
    off = trace["fullest"]
    walls = [[f"{p['wall_s']:.6f}" for p in ps]
             for ps in (profiles, trace["profiles"])]
    print(f"layer trace: {best['launches']} launches ({off['launches']} "
          f"with the spans off), {best['syncs']} syncs ({off['syncs']}), "
          f"{best['device_s']:.6f} s device in {best['wall_s']:.6f} s "
          f"({off['device_s']:.6f} s in {off['wall_s']:.6f} s), "
          f"{100.0 * inside / max(best['device_s'], 1e-12):.2f}% of device "
          f"time launched inside program spans; exclusive ms: "
          f"{_fmt(seconds, 1e3)}; syncs by span: {_fmt(syncs, 1, 0)}; "
          f"idle gaps ms: {_fmt(dict(idle_gaps(rows)), 1e3)}; unit walls "
          f"s, spans on {' '.join(walls[0])}, off {' '.join(walls[1])}; "
          f"{time.perf_counter() - t_start:.1f} s in all", file=sys.stderr)
    trace["layers"] = dict(fullest=best, seconds=seconds,
                           opened={n for *_, n in best["layers"]})
    return trace["layers"]


def ms_per_pass(trace, layer):
    """Exclusive device ms a pass (an SPPM iteration) of `layer` in the
    fullest unit of the layer trace: 0 for a layer that opened ranges
    but launched nothing, None for one that opened none."""
    t = traced(trace)
    if t is None or layer not in t["opened"]:
        return None
    return 1e3 * t["seconds"].get(layer, 0.0) / trace["per_unit"]


def inclusive_ms(trace, layer):
    """Device ms of the kernels launched inside `layer`, its children's
    included, in the fullest unit of the layer trace."""
    t = traced(trace)
    s = None if t is None else inclusive_seconds(t["fullest"], layer)
    return None if s is None else 1e3 * s


def live_lane_pct(trace):
    """100 x the live closest-hit and shadow tests of a one-pass job over
    the lanes its intersect calls carried (the sizes the driver's
    `intersect` wrapper records); None where the job counts no tests (a
    light-side integrator), and, as every reader here, on a program
    without spans."""
    st = trace["state"]
    if _spans_on() is None or not hasattr(st, "job"):
        return None
    from pbrt_tpu_torch.film import film as filmmod
    from pbrt_tpu_torch.integrators import dispatch
    from pbrt_tpu_torch.samplers.samplers import SamplerConfig
    from pbrt_tpu_torch.utils.stats import Stats

    driver = sys.modules[type(st).__module__]
    job = st.job
    fp = dict(job.filter_params)
    radius = fp.pop("radius", None)
    film = filmmod.make_film(st.width, st.height, job.filter_name,
                             radius=radius, device=st.device, **fp)
    cfg = SamplerConfig(kind=job.sampler_kind,
                        seed=job_seed(st.seed, st.n_jobs), spp=1)
    st.n_jobs += 1
    c = Stats()
    with profile.Spans(driver.spans(st)) as spans:
        dispatch.render_with_integrator(job, st.camera, film, cfg, 1,
                                        st.depth, max_rays_per_pass=st.lanes,
                                        stats=c)
    tests = sum(c.counters.get(k, 0) for k in LIVE_TESTS)
    lanes = sum(spans.sizes["intersect"])
    print(f"counted unit: {tests} live tests of {lanes} intersect lanes "
          f"in {len(spans.sizes['intersect'])} calls", file=sys.stderr)
    return 100.0 * tests / lanes if tests and lanes else None
