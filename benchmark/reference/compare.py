"""The comparison that decides a run's `correct`: what the timed path
produced against the plain reference, at the timed sizes.

Renders.  For a sample of pixels drawn from the run's seed, and for each
job the window rendered, the film's raw sums and filter weights there
against the reference's sums over the same sample indices with the same
sampler seed.  Three numbers, each with its limit (the traffic file's
`check.limits`):
- weight_gap: the largest gap between a pixel's filter weight and its
  sample count (a box filter weighs each sample 1, so it is exact);
- gap_share: the share of (pixel, job) sums whose gap exceeds 1e-3 of
  the sum (paths that branch apart on a rounding, at a facet's edge or a
  Russian-roulette threshold, make a few);
- mean_gap: the summed absolute gap over the summed reference, over all
  bins of all the sampled sums.
"""

from __future__ import annotations

import os

import torch

from benchmark.reference import path as rpath
from benchmark.reference import scene as rscene

REL = 1e-3


def render_numbers(port_raw, port_weight, ref_raw, ref_weight):
    """(weight_gap, gap_share, mean_gap) of [R,31] / [R] sums."""
    weight_gap = float((port_weight.double() - ref_weight.double()).abs()
                       .max())
    diff = (port_raw.double() - ref_raw.double()).abs()
    scale = ref_raw.double().abs().amax(-1) + 1e-6 * ref_weight.double()
    gap_share = float((diff.amax(-1) > REL * scale).double().mean())
    mean_gap = float(diff.sum() / ref_raw.double().abs().sum().clamp(
        min=1e-30))
    return weight_gap, gap_share, mean_gap


def _float32_matmuls(device):
    """TF32 off for the reference on a card (float32 as stated); returns
    the flags to restore."""
    was = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return was


def reference_film(sc, pixels, counts_of_list, seeds, W, H, device, dtype,
                   integrator="path"):
    """The reference's [R,31] raw sums and [R] filter weights at the
    sampled pixels, job (sampler seed) after job."""
    _float32_matmuls(device)
    T = rpath.Tables(sc, device, dtype)
    raws, weights = [], []
    for counts_of, s in zip(counts_of_list, seeds):
        raw, weight = rpath.render_film(T, pixels, counts_of, s, W, H,
                                        sc.max_depth, integrator)
        raws.append(raw)
        weights.append(weight)
    return torch.cat(raws), torch.cat(weights)


def sample_counts(passes, lanes, W, H):
    """counts_of(q): the samples pixel q got from `passes` passes of
    `lanes` pixels each, in pixel order."""
    n_pix = W * H
    n_chunks = max(-(-n_pix // lanes), 1)
    full, rem = divmod(passes, n_chunks)

    def counts_of(q):
        return full + (q < rem * lanes).to(q.dtype)
    return counts_of


def check_render(st):
    cell = st.cell
    tr = st.traffic
    limits = tr["check"]["limits"]
    W, H = st.width, st.height
    pixels = st.pixels
    light_side = tr["integrator"] == "sppm"
    seeds = [r["seed"] for r in st.results]
    counts = [sample_counts(r["passes"], st.lanes, W, H)
              for r in st.results]
    raw = torch.cat([r["raw"] for r in st.results])
    weight = torch.cat([r["weight"] for r in st.results])
    # the program's state goes before the reference runs
    st.job = st.camera = None
    st.results = []
    if st.device.type == "cuda":
        torch.cuda.empty_cache()
    sc = rscene.parse(os.path.join(cell["root"],
                                   cell["config_data"]["scene"]))
    if light_side:
        # a resolved film: each pixel holds its radiance, weight 1
        ref = sppm_sums(sc, pixels, seeds, W, H, st.device, torch.float32,
                        st.passes_per_unit,
                        tr.get("integrator_params", {}).get("radius"))
        ref_weight = torch.ones(ref.shape[0], device=ref.device)
    else:
        ref, ref_weight = reference_film(sc, pixels, counts, seeds, W, H,
                                         st.device, torch.float32,
                                         tr["integrator"])
    nums = render_numbers(raw, weight, ref, ref_weight)
    return [(n, v, float(limits[n])) for n, v in
            zip(("weight_gap", "gap_share", "mean_gap"), nums)]


def sppm_sums(sc, pixels, seeds, W, H, device, dtype, n_iterations,
              radius=None):
    """The SPPM reference's [R,31] radiance of the sampled pixels, a job
    (sampler seed) after a job."""
    from benchmark.reference import sppm

    _float32_matmuls(device)
    T = rpath.Tables(sc, device, dtype)
    r0 = radius if radius else T.world_radius * 0.01
    return torch.cat([sppm.render(T, pixels, s, W, H, sc.max_depth,
                                  n_iterations, r0) for s in seeds])


def grad_target(sc, sampler_seed, W, H, device, index=0, lanes=1 << 17):
    """The target image [W*H, 31] of the inverse render: the reference's
    render at the scene's own spectra, one sample a pixel at sample
    `index` under the steps' sampler seed.  It is an input made by the
    benchmark, handed to the program and to the reference alike."""
    was = _float32_matmuls(device)
    try:
        T = rpath.Tables(sc, device, torch.float32)
        out = torch.empty((W * H, 31), dtype=torch.float32, device=device)
        with torch.no_grad():
            for s in range(0, W * H, lanes):
                px = torch.arange(s, min(s + lanes, W * H), device=device)
                out[s:s + px.shape[0]] = rpath.trace(
                    T, px, torch.full_like(px, index), sampler_seed, W, H,
                    sc.max_depth)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = was
    return out


def grad_reference(cell, sc, target, pixels, sampler_seed, device,
                   dtype=torch.float32):
    """The reference's first steps of the gradient cell (losses, first
    gradients' norms by leaf, the parameters' change by leaf)."""
    from benchmark.reference import grad as rgrad

    tr = cell["traffic"]
    _float32_matmuls(device)
    T = rpath.Tables(sc, device, dtype)
    return rgrad.follow(T, target.to(dtype), pixels, 0, tr["checked_steps"],
                        sampler_seed, tr["width"], tr["height"], sc.max_depth,
                        tr["kd_scale"], tr["light_scale"],
                        tr["learning_rate"])


def worst_leaf(program, reference):
    """The largest gap between a leaf's norm in the program and in the
    reference, over the larger of that leaf's reference norm and the
    median leaf's.  With an even number of leaves the median is the lower
    one, so that with two leaves each is measured by its own norm and a
    fault in the smaller is not scaled down by the larger."""
    norms = sorted(reference.values())
    med = norms[(len(norms) - 1) // 2]
    return max(abs(program[k] - reference[k]) / max(reference[k], med, 1e-30)
               for k in reference)


def grad_numbers(first, losses, g_norm, change):
    loss_gap = max(abs(a - b) / max(abs(b), 1e-30)
                   for a, b in zip(first["losses"], losses))
    return (loss_gap, worst_leaf(first["grad_norm"], g_norm),
            worst_leaf(first["change"], change))


def check_grad(st):
    cell = st.cell
    limits = cell["traffic"]["check"]["limits"]
    first, target, pixels = st.first, st.target, st.pixels
    st.step = st.params = st.adam = None
    if st.device.type == "cuda":
        torch.cuda.empty_cache()
    sc = rscene.parse(os.path.join(cell["root"],
                                   cell["config_data"]["scene"]))
    ref = grad_reference(cell, sc, target, pixels, st.sampler_seed,
                         st.device)
    nums = grad_numbers(first, *ref)
    return [(n, v, float(limits[n])) for n, v in
            zip(("loss_gap", "grad_gap", "change_gap"), nums)]
