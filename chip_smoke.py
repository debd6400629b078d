"""Smoke test of the PyTorch/CUDA port (`pbrt_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the dense intersector's CUDA kernels from `pbrt_tpu_torch/csrc`,
holds each against its plain PyTorch version on the card at the shapes
the main path gives it, renders the Cornell scene (256x256, Sobol, 4 spp,
depth 5, 65,536 rays per pass) through the port's `render`, checks that
the render launched both kernels six times per pass, compares a small
render on the GPU with the same render on the CPU, and writes the .dat
and EXR outputs.  Any failed check raises, so the exit code is non-zero;
there is no fallback to the CPU.

The last line of standard output is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}};
the line before it lists every kernel with its launches, its largest
difference from the plain version and both times.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

# the smoke drives one card, cuda:0; on a machine with several, it sees
# only the first unless told otherwise
os.environ.setdefault("CUDA_VISIBLE_DEVICES", "0")

import torch  # noqa: E402  (after the device mask)

from pbrt_tpu_torch.film import film as filmmod
from pbrt_tpu_torch.film import io as filmio
from pbrt_tpu_torch.integrators import path
from pbrt_tpu_torch.models import flagship
from pbrt_tpu_torch.ops import cuda_kernels
from pbrt_tpu_torch.ops import dense_intersect as dense
from pbrt_tpu_torch.samplers.samplers import SamplerConfig

W = H = 256
SPP = 4
DEPTH = 5
RAYS_PER_PASS = 65536
T_SHARE = 0.99       # K2 lanes whose t is within 1e-5 relative of plain
KERNELS = {
    "dense_queue": ("pbrt_tpu_torch/csrc/dense_queue.cu",
                    "pbrt_tpu/ops/pallas_intersect.py:761"),
    "dense_loop": ("pbrt_tpu_torch/csrc/dense_loop.cu",
                   "pbrt_tpu/ops/pallas_intersect.py:329"),
}


def check(ok, what):
    if not ok:
        raise AssertionError(what)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, reps=20):
    """Mean device time of fn() in ms, by CUDA events, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def capture_batches(scene, camera, cfg, device):
    """The (r16, tmax) batches the main path hands the dense kernels in
    one pass: call 0 is the camera batch, call 1 the first trace_pair
    (bounce-1 rays + bounce-0 shadow rays)."""
    batches = []
    inner = dense.dense_intersect_loop

    def record(r16, tmax, W_, cb):
        batches.append((r16.clone(), tmax.clone()))
        return inner(r16, tmax, W_, cb)

    dense.dense_intersect_loop = record
    try:
        ids = torch.arange(RAYS_PER_PASS, device=device)
        ray, _, _, pid, sidx = path.camera_rays_for_pixels(
            camera, W, H, cfg, ids, 0)
        path.trace_paths(scene, ray, pid, sidx, cfg, max_depth=DEPTH)
    finally:
        dense.dense_intersect_loop = inner
    check(len(batches) == DEPTH + 1,
          f"expected {DEPTH + 1} intersect calls, got {len(batches)}")
    return {"camera": batches[0], "bounce1": batches[1]}


def compare_kernels(scene, batches, card):
    """K1 and K2 against their plain versions on the same CUDA tensors."""
    res = {k: {"max_abs_err": 0.0, "ms": {}, "plain_ms": {}}
           for k in KERNELS}
    cb, Wt = scene.dense_cb, scene.dense_w
    for name, (r16, tmax) in batches.items():
        # --- K1: hits identical, near within 1e-6 relative ---
        hits, near = dense.tile_queue(r16, tmax, cb)
        hits_p, near_p = dense.tile_queue_plain(r16, tmax, cb)
        check(torch.equal(hits, hits_p), f"K1 {name}: hits differ")
        err = (near - near_p)[hits].abs()
        rel = (err / near_p[hits].abs().clamp(min=1e-30)).max().item() \
            if err.numel() else 0.0
        check(rel <= 1e-6, f"K1 {name}: near rel err {rel}")
        res["dense_queue"]["max_abs_err"] = max(
            res["dense_queue"]["max_abs_err"],
            err.max().item() if err.numel() else 0.0)

        # --- K2: same chunk lists into kernel and plain version ---
        key = torch.where(hits, near, float("inf"))
        cl = torch.sort(key, dim=1, stable=True).indices.to(torch.int32)
        na = hits.sum(1, dtype=torch.int32)
        t_k, p_k = dense.loop_hits(r16, tmax, Wt, cl, na)
        t_p, p_p = dense.loop_hits_plain(r16, tmax, Wt, cl, na)
        anyhit = r16[:, 12] > 0.5
        found_agree = ((p_k >= 0) == (p_p >= 0)).float().mean().item()
        prim_agree = (p_k == p_p).float().mean().item()
        closest = ~anyhit & (p_k == p_p) & (p_k >= 0)
        terr = (t_k - t_p)[closest].abs()
        # t = num / (s0+s1+s2) cancels badly on some lanes (up to ~1e-3
        # relative for short bounce hits), so no fixed bound holds between
        # two f32 evaluations on every lane.  Every lane of both is held to
        # the f32 rounding bound of the exact t of its winning triangle;
        # the share of lanes where they agree within 1e-5 relative is held
        # to at least T_SHARE.
        t64, bound = dense.loop_t_reference(r16[closest], Wt, p_k[closest])
        ratio_k = ((t_k[closest] - t64).abs() / (bound * t64.abs())).max()
        ratio_p = ((t_p[closest] - t64).abs() / (bound * t64.abs())).max()
        share = (terr <= 1e-5 * t_p[closest].abs()).double().mean().item()
        occ_same = torch.equal((p_k >= 0)[anyhit], (p_p >= 0)[anyhit])
        print(f"K2 {name}: B={r16.shape[0]} any-hit lanes="
              f"{int(anyhit.sum())} found agree={found_agree:.6f} "
              f"prim agree={prim_agree:.6f} closest lanes compared="
              f"{int(closest.sum())} t within 1e-5 rel of plain={share:.6f} "
              f"largest t err / f32 bound: kernel {ratio_k.item():.4f} "
              f"plain {ratio_p.item():.4f} occluded identical={occ_same}")
        check(found_agree >= 0.9999, f"K2 {name}: found agree {found_agree}")
        check(prim_agree >= 0.999, f"K2 {name}: prim agree {prim_agree}")
        check(ratio_k <= 1.0, f"K2 {name}: kernel t beyond the f32 bound")
        check(ratio_p <= 1.0, f"K2 {name}: plain t beyond the f32 bound")
        check(share >= T_SHARE, f"K2 {name}: only {share} of lanes within "
              "1e-5")
        check(occ_same, f"K2 {name}: occluded flags differ")
        res["dense_loop"]["max_abs_err"] = max(
            res["dense_loop"]["max_abs_err"],
            terr.max().item() if terr.numel() else 0.0)

        res["dense_queue"]["ms"][name] = time_ms(
            lambda: dense.tile_queue(r16, tmax, cb))
        res["dense_queue"]["plain_ms"][name] = time_ms(
            lambda: dense.tile_queue_plain(r16, tmax, cb))
        res["dense_loop"]["ms"][name] = time_ms(
            lambda: dense.loop_hits(r16, tmax, Wt, cl, na))
        res["dense_loop"]["plain_ms"][name] = time_ms(
            lambda: dense.loop_hits_plain(r16, tmax, Wt, cl, na), reps=5)
        print(f"K1 {name}: B={r16.shape[0]} tiles={hits.shape[0]} "
              f"active chunks/tile={na.float().mean().item():.2f} "
              f"hits identical, near max rel err={rel:.3e} "
              f"kernel {res['dense_queue']['ms'][name]:.4f} ms "
              f"plain {res['dense_queue']['plain_ms'][name]:.4f} ms | "
              f"K2 kernel {res['dense_loop']['ms'][name]:.4f} ms "
              f"plain {res['dense_loop']['plain_ms'][name]:.4f} ms on {card}")
    return res


def compare_cpu(device):
    """The same render at 32x32, 2 spp on CUDA and on the CPU."""
    cfg = SamplerConfig("sobol", 0, 2)
    imgs = []
    for dev in (device, "cpu"):
        scene, cam = flagship.cornell(device=dev)
        film = path.render(scene, cam(32, 32),
                           filmmod.make_film(32, 32, "gaussian", device=dev),
                           cfg, 2, max_depth=DEPTH)
        imgs.append(filmmod.develop_spectral(film).cpu().numpy())
    g, c = (im.sum(-1) for im in imgs)
    mean_rel = abs(g.mean() / c.mean() - 1.0)
    close = (np.abs(g - c) <= 1e-2 * np.abs(c)).mean()
    print(f"GPU vs CPU 32x32 2spp: mean {g.mean():.6f} vs {c.mean():.6f} "
          f"(rel {mean_rel:.3e}), pixels within 1e-2 rel {close:.4f}")
    check(mean_rel < 0.01, f"GPU/CPU image mean differs by {mean_rel}")
    check(close >= 0.95, f"only {close} of pixels agree within 1e-2")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device visible to torch")
    check(torch.cuda.device_count() == 1,
          f"chip_smoke drives one card; {torch.cuda.device_count()} are "
          "visible (set CUDA_VISIBLE_DEVICES to one)")
    device = torch.device("cuda", 0)
    # the plain versions' matmuls must be true f32 on the card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card)
    print(f"phase 1 card: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | allow_tf32 matmul="
          f"{torch.backends.cuda.matmul.allow_tf32}")

    _, build_s, log = cuda_kernels.build()
    cuda_kernels.library()
    print(f"phase 2 build: {build_s:.2f} s (nvcc, sm_90a)")
    for line in log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            print("  ptxas: " + line.strip())

    scene, cam_ctor = flagship.cornell(device=device)
    camera = cam_ctor(W, H)
    cfg = SamplerConfig("sobol", 0, SPP)
    batches = capture_batches(scene, camera, cfg, device)
    res = compare_kernels(scene, batches, card)
    print("phase 3-4 kernels agree with their plain versions")

    # warm-up render (allocator, cuBLAS, caches), then the counted one
    path.render(scene, camera, filmmod.make_film(W, H, "gaussian",
                                                 device=device),
                cfg, 1, max_depth=DEPTH, max_rays_per_pass=RAYS_PER_PASS)
    torch.cuda.synchronize()
    film = filmmod.make_film(W, H, "gaussian", device=device)
    passes = SPP * (-(-W * H // RAYS_PER_PASS))
    dense.reset_launch_counts()
    t0 = time.perf_counter()
    film, n_rays = path.render(scene, camera, film, cfg, SPP,
                               max_depth=DEPTH,
                               max_rays_per_pass=RAYS_PER_PASS,
                               count_rays=True)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(dense.LAUNCHES)
    img = filmmod.develop_spectral(film)
    print(f"phase 5 render {W}x{H} {SPP} spp depth {DEPTH}: {passes} passes, "
          f"{dt * 1e3 / passes:.2f} ms/pass, {n_rays} rays, "
          f"{n_rays / dt:.4e} rays/s, launches {launches} on {card}")
    for k in KERNELS:
        check(launches[k] == (DEPTH + 1) * passes,
              f"{k}: {launches[k]} launches, expected {(DEPTH + 1) * passes}")
    check(bool(torch.isfinite(img).all()), "image has non-finite values")
    check(bool((img >= 0).all()), "image has negative values")
    check(img.mean().item() > 0, "image is black")
    print(f"  image mean {img.mean().item():.6f}")

    compare_cpu(device)
    print("phase 6 GPU and CPU renders agree")

    with tempfile.TemporaryDirectory() as d:
        dat = filmio.write_dat(os.path.join(d, "cornell.dat"), img)
        filmio.write_exr(os.path.join(d, "cornell.exr"),
                         filmmod.develop_rgb(film))
        back, flag = filmio.read_dat(dat)
        check(flag == "v3" and np.array_equal(
            back, img.cpu().numpy().astype(np.float64)), ".dat round trip")
        print(f"phase 7 wrote {os.path.getsize(dat)} B .dat and "
              f"{os.path.getsize(os.path.join(d, 'cornell.exr'))} B EXR; "
              ".dat read back equal")

    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[k], "max_abs_err": res[k]["max_abs_err"],
         "ms": res[k]["ms"]["bounce1"], "plain_ms": res[k]["plain_ms"]
         ["bounce1"], "ms_camera": res[k]["ms"]["camera"],
         "plain_ms_camera": res[k]["plain_ms"]["camera"]}
        for k, (src, rep) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
