"""Run one cell of the benchmark of `pbrt_tpu_torch` once, on the CUDA
cards of this machine, and print its result as the last line of
standard output.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell, its configuration, its traffic (`workloads/<traffic>.json`), its
driver (`drivers/<driver>.py`) and the readers of its per-layer metrics
(`metrics/<metric>.py`) are found by name from BENCHMARK.json at the root
of the checkout, so a cell, a configuration, a traffic mix or a metric is
added as new files and entries alone.

--trace 0 times the window and prints the cell's end-to-end metrics;
--trace 1 profiles a few units of work (the traffic's `profiled_units`
passes, SPPM jobs or steps) in place of the window and prints its
per-layer metrics.
Either way the window's output is compared with the plain reference
(benchmark/reference) once the window has closed, and each number
compared is printed beside its limit.  Without a CUDA card the run exits
with status 3 and prints no result: nothing falls back to the CPU.
"""

from __future__ import annotations

import os
import time


def _process_age():
    """Seconds since this process started (its start time in /proc)."""
    try:
        with open("/proc/self/stat") as f:
            start = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(up - start / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


T_PROCESS = time.perf_counter() - _process_age()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
# top-level modules that must not be loaded in a run: JAX and the JAX
# package (compared whole, so that pbrt_tpu_torch is not taken for it)
FORBIDDEN = ("jax", "jaxlib", "flax", "pbrt_tpu")
CACHE_DIR = os.path.join(BENCH_DIR, "_cache")


def load_cell(name, root=ROOT):
    """The cell `name` of root/BENCHMARK.json as a dict: its entry, its
    configuration, its traffic and the metrics it reports, every file
    read from root.  Raises KeyError for a cell the file does not name."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    w = cells[name]
    config = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(os.path.join(root, config["file"])) as f:
        config_data = json.load(f)
    with open(os.path.join(root, "benchmark", "workloads",
                           f"{w['traffic']}.json")) as f:
        traffic = json.load(f)
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    e2e_names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m
                 else m["moves"] in e2e_names)]
    return dict(name=name, root=root, entry=w, config=config,
                config_data=config_data, traffic=traffic, end_to_end=e2e,
                per_layer=layer)


def load_module(root, folder, name):
    """benchmark/<folder>/<name>.py under root, loaded by its path (a
    metric's name may hold a dot)."""
    path = os.path.join(root, "benchmark", folder, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{folder}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def execute(cell, seed, seconds, trace, device, t_process):
    """Set up, run the window (trace 0) or the profiled units (trace 1),
    check the output; returns the result dict (the JSON line's keys)."""
    import torch
    from benchmark import profile

    driver = load_module(cell["root"], "drivers",
                         cell["traffic"]["driver"])
    t0 = time.perf_counter()
    if device.type == "cuda":
        torch.zeros(1, device=device)
        torch.cuda.synchronize(device)
        # the program's kernels: built at the first run in a checkout,
        # loaded from its build directory after
        from pbrt_tpu_torch.ops import cuda_kernels
        cuda_kernels.library()
    t1 = time.perf_counter()
    state = driver.setup(cell, seed, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t_window = time.perf_counter()
    setup_s = t_window - t_process
    state.setup_times.update(import_s=t0 - t_process,
                             cuda_init_kernel_load_s=t1 - t0)
    print("setup: " + ", ".join(f"{k} {v:.3f}" for k, v in
                                sorted(state.setup_times.items()))
          + f", total {setup_s:.3f} s", file=sys.stderr)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    metrics = {}
    trace_data = None
    if trace:
        trace_data = profile.profile_units(state, driver, device)
        trace_data["setup"] = state.setup_times
        trace_data["peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                                    if device.type == "cuda" else 0)
        for m in cell["per_layer"]:
            reader = load_module(cell["root"], "metrics", m["name"])
            v = reader.read(trace_data)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        attempted = trace_data["units"]
    else:
        done = driver.window(state, seconds)
        window_s = done["seconds"]
        attempted = done["units"]
        rates = dict(samples_per_s=done.get("samples", 0) / window_s,
                     step_ms=1e3 * window_s / max(done["units"], 1),
                     setup_s=setup_s)
        for m in cell["end_to_end"]:
            metrics[m["name"]] = {"value": rates[m["name"]],
                                  "unit": m["unit"]}
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    checks = driver.check(state)
    correct = all(v <= lim for _, v, lim in checks)
    dev = dict(platform="gpu" if device.type == "cuda" else device.type,
               kind=(torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu"),
               count=1, memory_peak_bytes=int(peak))
    result = dict(correct=bool(correct), attempted=int(attempted),
                  failed=0, metrics=metrics, device=dev)
    if trace_data is not None:
        dev["busy_s"] = trace_data["busy_s"]
        dev["window_s"] = trace_data["window_s"]
        result["breakdown"] = trace_data["breakdown"]
    result["compared"] = {n: {"value": v, "limit": lim}
                          for n, v, lim in checks}
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(prog="benchmark.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    # build and kernel caches at fixed paths inside the checkout
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE_DIR,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE_DIR, "triton")
    import torch
    chips = int(cell["entry"]["chips"])
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        print(f"benchmark.run: {args.workload} needs {chips} CUDA card(s); "
              f"this machine has {have}; no result", file=sys.stderr)
        return 3
    result = execute(cell, args.seed, args.seconds, args.trace,
                     torch.device("cuda", 0), T_PROCESS)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark.run: the run loaded {', '.join(bad)}; no result",
              file=sys.stderr)
        return 4
    for name, c in result["compared"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
