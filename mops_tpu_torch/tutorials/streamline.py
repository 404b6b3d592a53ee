"""Streamline tutorial on the port (counterpart of tutorials/streamline.py):
long steady-field integration.

Mirrors reference tutorial/streamLine.cpp (dt = 1 min, record = 6 min,
multi-day forward RK4 from a lat-lon seed box), on a YAML dataset or the
synthetic mesh, in float64 through the MOPSApp API:

    python -m mops_tpu_torch.tutorials.streamline [--days 5] [--out FILE]
    python -m mops_tpu_torch.tutorials.streamline --device cpu
"""

import argparse

from .. import api, synth
from ..io import image as imgio
from ..settings import (ONE_DAY, ONE_MINUTE, FailMode, SamplingSettings,
                        TrajectorySettings)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--yaml")
    ap.add_argument("--synthetic", type=int, default=5000)
    ap.add_argument("--days", type=int, default=5)
    ap.add_argument("--out", default="streamline.vtp")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card, default) or cpu")
    args = ap.parse_args(argv)

    app = api.MOPSApp()
    app.init(args.device, precision="fp64")
    app.begin()
    if args.yaml:
        from ..io import MPASOReader, StreamConfig
        reader = MPASOReader(StreamConfig.parse(args.yaml))
        mesh = reader.read_mesh()
        raw = reader.read_solution(0)
        raw.pop("_timestamp", None)
    else:
        mesh = synth.build_voronoi_mesh(args.synthetic, jitter=0.05)
        raw = synth.solid_body_fields(mesh, n_layers=20)
    app.add_grid(mesh)
    app.add_solution(1, raw)
    app.end()
    app.active_attribute(1)

    seeds = app.generate_sample_points(SamplingSettings(
        sample_range=(8, 8), lat_range=(20, 50), lon_range=(-80, -50),
        depth=10.0))
    cfg = TrajectorySettings(
        delta_t=ONE_MINUTE, record_t=6 * ONE_MINUTE,
        simulation_duration=args.days * ONE_DAY, depth=10.0,
        fail_mode=FailMode.ZERO)
    lines = app.run_streamline(cfg, seeds)
    imgio.save_trajectories_vtp(args.out, lines)
    print(f"wrote {len(lines)} lines x {lines[0].points.shape[0]} points "
          f"to {args.out}")
    return lines


if __name__ == "__main__":
    main()
