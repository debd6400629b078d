"""lenstool (port of pbrt_tpu.tools.lenstool; reference:
src/tools/lenstool.cpp:35-49).

Commands:
  convert <in.dat> <out.json>             legacy lens -> omni JSON
  insertmicrolens <in.json> <out.json>    add a microlens array description

    python -m pbrt_tpu_torch.tools.lenstool convert lens.dat lens.json
"""

from __future__ import annotations

import argparse
import json
import sys

from pbrt_tpu_torch.cameras.lens import read_dat_lens


def convert(dat_path, json_path):
    """Legacy 4-column .dat -> omni JSON (units back to mm)."""
    surfs = read_dat_lens(dat_path)
    out = {
        "name": dat_path,
        "description": f"converted from {dat_path} by pbrt_tpu lenstool",
        "surfaces": [
            {
                "radius": s["radius_x"] * 1e3,
                "thickness": s["thickness"] * 1e3,
                "ior": s["eta"],
                "semi_aperture": s["semi_aperture"] * 1e3,
                "conic_constant": 0.0,
            }
            for s in surfs
        ],
    }
    with open(json_path, "w") as f:
        json.dump(out, f, indent=2)
    return json_path


def insert_microlens(in_json, out_json, xdim=64, ydim=64,
                     microlens_surfaces=None, offset_mm=0.05):
    """Add a microlens-array block (reference lenstool.cpp insertmicrolens:
    the microlens JSON with its dimensions and zero offsets)."""
    with open(in_json) as f:
        j = json.load(f)
    if microlens_surfaces is None:
        microlens_surfaces = [
            {"radius": 0.05, "thickness": offset_mm, "ior": 1.5,
             "semi_aperture": 0.05, "conic_constant": 0.0}]
    j["microlens"] = {
        "dimensions": [xdim, ydim],
        "offsets": [[0.0, 0.0]] * (xdim * ydim),
        "surfaces": microlens_surfaces,
    }
    with open(out_json, "w") as f:
        json.dump(j, f, indent=2)
    return out_json


def main(argv=None):
    ap = argparse.ArgumentParser(prog="lenstool")
    sub = ap.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("convert")
    c.add_argument("input")
    c.add_argument("output")
    m = sub.add_parser("insertmicrolens")
    m.add_argument("input")
    m.add_argument("output")
    m.add_argument("--xdim", type=int, default=64)
    m.add_argument("--ydim", type=int, default=64)
    args = ap.parse_args(argv)
    if args.cmd == "convert":
        print(convert(args.input, args.output))
    else:
        print(insert_microlens(args.input, args.output, args.xdim,
                               args.ydim))
    return 0


if __name__ == "__main__":
    sys.exit(main())
