"""bsdftest — BSDF sampling / evaluation consistency harness (port of
pbrt_tpu.tools.bsdftest; reference: src/tools/bsdftest.cpp).

    python -m pbrt_tpu_torch.tools.bsdftest --material plastic \
        --samples 100000 [--cpu]

Samples `--samples` directions from one material at a fixed outgoing
direction with `materials/bsdf.py::sample_f` and re-evaluates each with
`eval_f` and `pdf_f`; prints the valid fraction, the hemispherical
albedo (bin 15), the transmitted fraction and the largest sample /
evaluation differences, then PASS (exit 0) when f and pdf agree within
1e-3 and the albedo is under 1.5, else FAIL (exit 1).  The uniforms are
numpy's RandomState(0), as in the JAX package, so both draw the same
samples.  It runs on the first CUDA card, on the CPU with --cpu.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from pbrt_tpu_torch.core import device as devmod
from pbrt_tpu_torch.materials import bsdf
from pbrt_tpu_torch.scene import ir

MATERIALS = {
    "matte": ("MAT_MATTE", {}),
    "orennayar": ("MAT_MATTE", {"sigma": 20.0}),
    "plastic": ("MAT_PLASTIC", {}),
    "metal": ("MAT_METAL", {}),
    "substrate": ("MAT_SUBSTRATE", {}),
    "translucent": ("MAT_TRANSLUCENT", {"kr": 0.5, "kt": 0.5}),
    "retroreflective": ("MAT_RETRO", {}),
    "roughglass": ("MAT_ROUGHGLASS", {"rough": 0.3}),
}


def run(material, samples=100000, theta=30.0, device=None):
    """The harness's numbers for one material: a dict of valid, albedo,
    transmitted, cons_f, cons_p and status (0 PASS, 1 FAIL)."""
    device = devmod.resolve(device)
    tag, kw = MATERIALS[material]
    B = samples
    rs = np.random.RandomState(0)
    th = np.radians(theta)

    def full(shape, v):
        return torch.full(shape, float(v), dtype=torch.float32,
                          device=device)
    wo = torch.tensor([np.sin(th), 0.0, np.cos(th)], dtype=torch.float32,
                      device=device).expand(B, 3)
    p = bsdf.MaterialParams(
        type=torch.full((B,), getattr(ir, tag), dtype=torch.int32,
                        device=device),
        kd=full((B, 31), kw.get("kd", 0.6)),
        ks=full((B, 31), kw.get("ks", 0.4)),
        kr=full((B, 31), kw.get("kr", 1.0)),
        kt=full((B, 31), kw.get("kt", 1.0)),
        rough_u=full((B,), kw.get("rough", 0.2)),
        rough_v=full((B,), kw.get("rough", 0.2)),
        eta=full((B,), 1.5), sigma=full((B,), kw.get("sigma", 0.0)),
        eta_spec=full((B, 31), 0.2), k_spec=full((B, 31), 3.0),
        opacity=full((B, 31), 1.0))
    u = [torch.from_numpy(rs.rand(B).astype(np.float32)).to(device)
         for _ in range(3)]
    wi, f, pdf, _, trans, _ = bsdf.sample_f(p, wo, *u)
    f2 = bsdf.eval_f(p, wo, wi)[:, 15].cpu().numpy()
    pdf2 = bsdf.pdf_f(p, wo, wi).cpu().numpy()
    pdf = pdf.cpu().numpy()
    f15 = f[:, 15].cpu().numpy()
    cos = np.abs(wi[:, 2].cpu().numpy())
    ok = pdf > 1e-6
    albedo = np.where(ok, f15 * cos / np.maximum(pdf, 1e-6), 0.0).mean()
    cons_f = np.abs(f2[ok] - f15[ok]).max() if ok.any() else 0.0
    cons_p = np.abs(pdf2[ok] - pdf[ok]).max() if ok.any() else 0.0
    status = 0 if (cons_f < 1e-3 and cons_p < 1e-3 and albedo < 1.5) else 1
    return {"valid": ok.mean(), "albedo": albedo,
            "transmitted": trans.float().mean().item(), "cons_f": cons_f,
            "cons_p": cons_p, "status": status}


def main(argv=None):
    ap = argparse.ArgumentParser(prog="bsdftest")
    ap.add_argument("--material", default="plastic",
                    choices=sorted(MATERIALS))
    ap.add_argument("--samples", type=int, default=100000)
    ap.add_argument("--theta", type=float, default=30.0,
                    help="wo zenith angle in degrees")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the CUDA card")
    args = ap.parse_args(argv)
    r = run(args.material, args.samples, args.theta,
            "cpu" if args.cpu else None)
    print(f"material {args.material}  wo theta {args.theta} deg  "
          f"samples {args.samples}")
    print(f"  valid sample fraction : {r['valid']:.4f}")
    print(f"  hemispherical albedo  : {r['albedo']:.4f} (bin 15)")
    print(f"  transmitted fraction  : {r['transmitted']:.4f}")
    print(f"  max |f(sample)-f(eval)|   : {r['cons_f']:.3e}")
    print(f"  max |pdf(sample)-pdf(eval)|: {r['cons_p']:.3e}")
    print("  PASS" if r["status"] == 0 else "  FAIL")
    return r["status"]


if __name__ == "__main__":
    sys.exit(main())
