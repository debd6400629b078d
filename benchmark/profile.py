"""The traced run: a few units of the cell's work (render passes or
gradient steps), each under torch.profiler, with spans recorded around
calls into the program's layers.

A span is a `torch.profiler.record_function` range opened by a wrapper
that the benchmark puts on a module attribute of the program for the
traced run only (the driver names the attributes); nothing inside the
program changes.  A kernel belongs to a span when the host launched it
inside the span's range: each device kernel is matched to the runtime
call that launched it by its CUPTI correlation id.

As `tools/kernel_workloads.py::device_ms` does, every unit is traced on
its own and the unit whose trace holds the most kernels is read, since a
trace on the H100 now and then comes back with kernels missing.
"""

from __future__ import annotations

import bisect
import functools
import sys
import time

import torch
from torch.autograd import DeviceType

UNIT = "bench.unit"
# host calls that wait for the device (a D2H copy waits through them)
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy", "cuStreamSynchronize",
              "cuCtxSynchronize", "cuEventSynchronize")
NOT_LAUNCHES = ("Memcpy", "Memset")


def _wrap(fn, label, sizes, size_of):
    @functools.wraps(fn)
    def wrapper(*a, **k):
        if size_of is not None:
            sizes.append(size_of(*a, **k))
        with torch.profiler.record_function(f"bench.{label}"):
            return fn(*a, **k)
    return wrapper


class Spans:
    """Wrappers on (module, attribute) pairs, removed on exit.  specs:
    (label, module, attribute, size_of or None); size_of(*args) gives a
    number recorded per call (a batch's lanes)."""

    def __init__(self, specs):
        self.specs = specs
        self.sizes = {label: [] for label, *_ in specs}
        self._saved = []

    def __enter__(self):
        for label, mod, attr, size_of in self.specs:
            fn = getattr(mod, attr)
            self._saved.append((mod, attr, fn))
            setattr(mod, attr, _wrap(fn, label, self.sizes[label], size_of))
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in reversed(self._saved):
            setattr(mod, attr, fn)
        self._saved.clear()


def _read(prof, wall_s):
    """The numbers of one unit's trace."""
    events = prof.events()
    # device operations; a record_function range also shows on the device
    # timeline (a user annotation spanning its kernels): not an operation
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and e.time_range.end > e.time_range.start
               and not e.name.startswith("bench.")
               and not getattr(e, "is_user_annotation", False)]
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    launch_at = {e.id: e.time_range.start for e in cpu
                 if e.name.startswith("cu")}
    by_id = {e.id: e for e in cpu if not e.name.startswith("cu")}
    spans = {}
    unit = None
    for e in cpu:
        if e.name.startswith("bench."):
            spans.setdefault(e.name[6:], []).append(
                (e.time_range.start, e.time_range.end))
            if e.name == UNIT:
                unit = (e.time_range.start, e.time_range.end)
    # the host op that launched each kernel: the innermost non-runtime
    # op whose range holds the launch
    ops = sorted((e.time_range.start, e.time_range.end, e.name) for e in cpu
                 if not e.name.startswith(("cu", "bench.")))
    starts = [o[0] for o in ops]
    rows = []
    for k in kernels:
        t = launch_at.get(k.id)
        op = by_id.get(getattr(k, "linked_correlation_id", None))
        if t is None and op is not None:
            t = op.time_range.start
        name = op.name if op is not None else None
        if name is None and t is not None:
            i = bisect.bisect_right(starts, t) - 1
            for j in range(i, max(i - 64, -1), -1):
                if ops[j][1] >= t:
                    name = ops[j][2]
                    break
        rows.append(dict(name=k.name, dur_s=(k.time_range.end
                                             - k.time_range.start) * 1e-6,
                         start=k.time_range.start, end=k.time_range.end,
                         launched=t, op=name))
    syncs = sum(1 for e in cpu if e.name in SYNC_CALLS and unit is not None
                and unit[0] <= e.time_range.start <= unit[1])
    return dict(wall_s=wall_s, kernels=rows, spans=spans, syncs=syncs,
                launches=sum(1 for r in rows
                             if not r["name"].startswith(NOT_LAUNCHES)),
                device_s=sum(r["dur_s"] for r in rows),
                matched=sum(1 for r in rows if r["launched"] is not None))


def span_seconds(profile, label):
    """Device seconds of the kernels launched inside any `label` span."""
    ranges = profile["spans"].get(label, [])
    if not ranges:
        return None
    total = 0.0
    for r in profile["kernels"]:
        t = r["launched"]
        if t is not None and any(a <= t <= b for a, b in ranges):
            total += r["dur_s"]
    return total


def idle_pct(trace):
    """The device's idle share of the fullest traced unit, in percent."""
    p = trace["fullest"]
    return 100.0 * (1.0 - p["device_s"] / p["wall_s"])


def peak_gib(trace):
    """The traced units' peak device memory in GiB."""
    return trace["peak_bytes"] / 2 ** 30


def _breakdown(p):
    """The device ops that took most time, and the idle gaps before each
    kernel summed by what the host was doing: the span the kernel was
    launched in, else the op that launched it."""
    ops = {}
    for r in p["kernels"]:
        ops[r["name"]] = ops.get(r["name"], 0.0) + r["dur_s"]
    ks = sorted(p["kernels"], key=lambda r: r["start"])
    spans = sorted((a, b, n) for n, rs in p["spans"].items() if n != "unit"
                   for a, b in rs)
    gaps = {}
    for a, b in zip(ks, ks[1:]):
        g = (b["start"] - a["end"]) * 1e-6
        if g <= 0:
            continue
        label = b["op"] or "host"
        t = b["launched"]
        if t is not None:
            inner = [n for s0, s1, n in spans if s0 <= t <= s1]
            if inner:
                label = f"{inner[-1]}: {label}"
        gaps[label] = gaps.get(label, 0.0) + g
    top = sorted(ops.items(), key=lambda x: -x[1])[:10]
    top_gaps = sorted(gaps.items(), key=lambda x: -x[1])[:10]
    return dict(device_ops=[[n, s] for n, s in top],
                idle_gaps=[[n, s] for n, s in top_gaps])


def profile_units(state, driver, device):
    """Trace driver.unit(state) n times (the traffic's profiled_units);
    returns the trace data the metric readers take."""
    n = int(state.traffic.get("profiled_units", 3))
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    profiles = []
    with Spans(driver.spans(state)) as spans:
        for _ in range(n):
            before = {k: len(v) for k, v in spans.sizes.items()}
            with torch.profiler.profile(activities=acts) as prof:
                t0 = time.perf_counter()
                with torch.profiler.record_function(UNIT):
                    driver.unit(state)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                wall = time.perf_counter() - t0
            p = _read(prof, wall)
            p["sizes"] = {k: v[before[k]:] for k, v in spans.sizes.items()}
            profiles.append(p)
            print(f"traced unit: {p['launches']} launches, {p['matched']} of "
                  f"{len(p['kernels'])} device ops matched to their launch, "
                  f"{p['syncs']} syncs, {p['device_s']:.6f} s device in "
                  f"{wall:.6f} s", file=sys.stderr)
    best = max(profiles, key=lambda p: p["launches"])
    return dict(units=n, per_unit=getattr(state, "passes_per_unit", 1),
                profiles=profiles, fullest=best,
                busy_s=best["device_s"], window_s=best["wall_s"],
                breakdown=_breakdown(best), state=state)
