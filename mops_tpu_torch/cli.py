"""Command-line front-end, mirroring the reference CLI demo pipeline
(reference CLI/main.cpp:27-286): ingest a YAML-described dataset (or a
synthetic mesh), remap at fixed depth, seed a lat-lon box, run a 1-day
streamline, and write PNG/VTI/VTP/text outputs (mirror of mops_tpu.cli).
It runs on the card unless given ``--device cpu``.

Usage:
  python -m mops_tpu_torch.cli --yaml mpas.yaml --timestep 0 --depth 10 \
      --remap-size 1201x601 --samples 31x31 --out out/
  python -m mops_tpu_torch.cli --synthetic 5000 --out out/   # no data needed
  python -m mops_tpu_torch.cli --synthetic 2000 --device cpu --out out/
"""

from __future__ import annotations

import argparse
import os
import sys

from . import api, synth
from .io import MPASOReader, StreamConfig, image as imgio
from .settings import (CalcMethod, FailMode, SamplingSettings,
                       TrajectorySettings, VisualizationSettings, ONE_DAY,
                       ONE_MINUTE)


def _parse_size(text, default):
    if not text:
        return default
    w, h = text.lower().split("x")
    return int(w), int(h)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="mops_tpu_torch",
        description="MPAS-O particle advection on PyTorch and CUDA")
    ap.add_argument("-i", "--yaml", help="stream YAML config")
    ap.add_argument("-p", "--prefix", help="data path prefix override")
    ap.add_argument("-t", "--timestep", type=int, default=0)
    ap.add_argument("-d", "--depth", type=float, default=10.0)
    ap.add_argument("--synthetic", type=int, metavar="N_CELLS",
                    help="use a synthetic N-cell mesh instead of --yaml")
    ap.add_argument("--layers", type=int, default=20,
                    help="synthetic mesh vertical layers")
    ap.add_argument("--remap-size", default="360x180")
    ap.add_argument("--samples", default="31x31")
    ap.add_argument("--box", default="20,50,-80,-50",
                    help="seed box min_lat,max_lat,min_lon,max_lon "
                         "(reference demo: North Atlantic)")
    ap.add_argument("--dt", type=int, default=2 * ONE_MINUTE)
    ap.add_argument("--duration", type=int, default=ONE_DAY)
    ap.add_argument("--record", type=int, default=ONE_MINUTE)
    ap.add_argument("--method", choices=["rk4", "euler"], default="rk4")
    ap.add_argument("--fail-mode", choices=["freeze", "zero"], default="zero")
    ap.add_argument("--precision", choices=["fp64", "fp32"], default="fp64")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="run on the card (default) or on the CPU")
    ap.add_argument("--devices", type=int, default=1,
                    help="split the particles over this many devices: "
                         "cards 0..n-1, or n CPU shards with --device cpu")
    ap.add_argument("-o", "--out", default="out")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    app = api.MOPSApp()
    app.init(args.device, precision=args.precision, devices=args.devices)
    app.begin()

    if args.synthetic:
        mesh = synth.build_voronoi_mesh(args.synthetic, jitter=0.05)
        raw = synth.solid_body_fields(mesh, n_layers=args.layers)
        app.add_grid(mesh)
        app.add_solution(1, raw, timestamp="synthetic", timestep=0)
    elif args.yaml:
        cfg = StreamConfig.parse(args.yaml, path_prefix_override=args.prefix)
        reader = MPASOReader(cfg)
        mesh = reader.read_mesh()
        raw = reader.read_solution(args.timestep)
        ts = raw.pop("_timestamp", f"t{args.timestep}")
        app.add_grid(mesh)
        app.add_solution(1, raw, timestamp=ts, timestep=args.timestep)
    else:
        ap.error("provide --yaml or --synthetic")

    app.end()
    app.active_attribute(1)

    # 1. remapping (reference CLI/main.cpp:133-185)
    rw, rh = _parse_size(args.remap_size, (360, 180))
    vis = VisualizationSettings(image_width=rw, image_height=rh,
                                fixed_depth=args.depth)
    imgs = app.run_remapping(vis)
    imgio.save_image_channels_png(os.path.join(args.out, "remap"), imgs[0],
                                  ("east", "north", "speed"))
    imgio.save_vti(os.path.join(args.out, "remap.vti"), imgs,
                   ["velocity", "attrs"][:len(imgs)])
    print(f"[cli] remap {rw}x{rh} written to {args.out}/remap_*.png")

    # 2. seeding + streamline (reference CLI/main.cpp:187-275)
    n_lat, n_lon = _parse_size(args.samples, (31, 31))
    box = [float(v) for v in args.box.split(",")]
    samp = SamplingSettings(sample_range=(n_lat, n_lon),
                            lat_range=(box[0], box[1]),
                            lon_range=(box[2], box[3]), depth=args.depth)
    seeds = app.generate_sample_points(samp)
    traj_cfg = TrajectorySettings(
        delta_t=args.dt, simulation_duration=args.duration,
        record_t=args.record, depth=args.depth,
        method=CalcMethod.RK4 if args.method == "rk4" else CalcMethod.EULER,
        fail_mode=FailMode.FREEZE if args.fail_mode == "freeze" else FailMode.ZERO)
    lines = app.run_streamline(traj_cfg, seeds)
    imgio.save_trajectories_vtp(os.path.join(args.out, "streamline.vtp"), lines)
    imgio.save_trajectories_text(os.path.join(args.out, "streamline.txt"), lines)
    print(f"[cli] {len(lines)} streamlines written to {args.out}/streamline.vtp")

    api.MOPS_PrintTimingSummary()
    return 0


if __name__ == "__main__":
    sys.exit(main())
