"""Remapping tutorial on the port (counterpart of tutorials/remapping.py):
global fixed-depth velocity/attribute rasterization.

Mirrors reference tutorial/reMapping.cpp (global lon/lat image at a fixed
depth, saved as PNG + VTI), in float64 through the MOPSApp API:

    python -m mops_tpu_torch.tutorials.remapping [--size 1201x601] [--out P]
    python -m mops_tpu_torch.tutorials.remapping --device cpu
"""

import argparse

from .. import api, synth
from ..io import image as imgio
from ..settings import VisualizationSettings


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--synthetic", type=int, default=5000)
    ap.add_argument("--size", default="1201x601")
    ap.add_argument("--depth", type=float, default=20.0)
    ap.add_argument("--out", default="remap")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card, default) or cpu")
    args = ap.parse_args(argv)

    w, h = (int(v) for v in args.size.split("x"))
    mesh = synth.build_voronoi_mesh(args.synthetic, jitter=0.05)
    raw = synth.solid_body_fields(mesh, n_layers=20)

    app = api.MOPSApp()
    app.init(args.device, precision="fp64")
    app.begin()
    app.add_grid(mesh)
    app.add_solution(1, raw)
    app.end()
    app.active_attribute(1)

    cfg = VisualizationSettings(image_width=w, image_height=h,
                                fixed_depth=args.depth)
    imgs = app.run_remapping(cfg)
    imgio.save_image_channels_png(args.out, imgs[0], ("east", "north", "speed"))
    imgio.save_vti(args.out + ".vti", imgs, ["velocity", "attrs"][:len(imgs)])
    print(f"wrote {w}x{h} remap to {args.out}_*.png / {args.out}.vti")
    return imgs


if __name__ == "__main__":
    main()
