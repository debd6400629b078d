"""Render statistics and profiling phases (port of pbrt_tpu.utils.stats;
reference: src/core/stats.{h,cpp}).

* counters: accumulated on the host per render (the wavefront passes
  count their real work: `trace_paths(count_rays="full")`, summed by
  `integrators.path.render(stats=...)`);
* phases: wall-clock timers, each inside a
  `torch.profiler.record_function(name)`, so a torch.profiler trace shows
  the same phase breakdown the report prints.  A phase does not
  synchronise the card: a caller timing device work synchronises before
  the phase ends (the CLI does at the end of its render phase);
* layer spans: `span(name)` marks a layer boundary of the render and
  gradient paths (the sampler, camera, intersect, interaction, shading,
  lights, film, gather, pass, job, step, forward and backward layers).
  Off, which is the default, a span opens nothing.  Inside `tracing()`
  each span opens a `torch.profiler.record_function` range named
  "pbrt.<name>", so a profiler trace puts every kernel down to the
  innermost layer whose range holds its launch.

`report` prints the JAX package's text for the same counters and times.
"""

from __future__ import annotations

import functools
import time
from collections import defaultdict
from contextlib import contextmanager

import torch

#: the profiler ranges of the layer spans are named PREFIX + name
PREFIX = "pbrt."


class Stats:
    """Category/name counters + phase timers (PrintStats, api.cpp:1726)."""

    def __init__(self):
        self.counters = defaultdict(int)
        self.ratios = {}           # name -> (num, den), printed num/den
        self.times = defaultdict(float)

    def add(self, name, value=1):
        self.counters[name] += int(value)

    @contextmanager
    def phase(self, name):
        """Timer + torch.profiler range (ProfilePhase, stats.h:141)."""
        t0 = time.perf_counter()
        try:
            with torch.profiler.record_function(name):
                yield
        finally:
            self.times[name] += time.perf_counter() - t0

    def report(self, out=print):
        out("Statistics:")
        cats = defaultdict(list)
        for name, v in sorted(self.counters.items()):
            cat, _, item = name.partition("/")
            cats[cat].append((item or cat, f"{v:>16,d}"))
        for name, (num, den) in sorted(self.ratios.items()):
            cat, _, item = name.partition("/")
            cats[cat].append((item or cat,
                              f"{num / max(den, 1e-9):>16.3f} avg"))
        for cat in sorted(cats):
            out(f"  {cat}")
            for item, v in cats[cat]:
                out(f"    {item:<42}{v}")
        if self.times:
            total = sum(self.times.values())
            out("  Profile (wall clock)")
            for name, t in sorted(self.times.items(), key=lambda kv: -kv[1]):
                pct = 100.0 * t / max(total, 1e-9)
                out(f"    {name:<42}{t:>10.2f}s ({pct:4.1f}%)")


# True inside `tracing()`: the layer spans open their profiler ranges
_on = False


@contextmanager
def tracing():
    """Turn the layer spans on inside the block."""
    global _on
    outer, _on = _on, True
    try:
        yield
    finally:
        _on = outer


class _Off:
    """A span while tracing is off: a no-op context manager, and a
    decorator whose wrapper opens the span's range around each call made
    while tracing is on."""

    __slots__ = ("name",)

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __call__(self, fn):
        label = PREFIX + self.name

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            if not _on:
                return fn(*args, **kwargs)
            with torch.profiler.record_function(label):
                return fn(*args, **kwargs)
        return spanned


_OFF = {}


def span(name):
    """The layer span `name`, as a decorator (`@span("sampler")`, applied
    where tracing is off, as at import) or as a context manager (`with
    span("pass"):`).  Off, it is a shared no-op; on, a profiler range."""
    if _on:
        return torch.profiler.record_function(PREFIX + name)
    off = _OFF.get(name)
    if off is None:
        off = _OFF[name] = _Off(name)
    return off


def count_scene(stats, n_prims, n_lights, n_nodes=0):
    """Static scene-size counters (the reference's Scene/Memory stats);
    ray and path counters come from the render's own counts."""
    stats.add("Scene/Primitives", n_prims)
    stats.add("Scene/Lights", n_lights)
    if n_nodes:
        stats.add("Scene/BVH nodes", n_nodes)
