"""ReGrid tutorial on the port (counterpart of tutorials/regrid.py):
fixed-latitude depth/longitude cross-section.

Mirrors reference tutorial/reGrid.cpp (latitude 45 degrees, 720 x
nVertLevels section image), in float64 through the MOPSApp API:

    python -m mops_tpu_torch.tutorials.regrid [--lat 45] [--out P]
    python -m mops_tpu_torch.tutorials.regrid --device cpu
"""

import argparse

from .. import api, synth
from ..io import image as imgio
from ..settings import VisualizationSettings


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--synthetic", type=int, default=5000)
    ap.add_argument("--lat", type=float, default=45.0)
    ap.add_argument("--width", type=int, default=720)
    ap.add_argument("--out", default="regrid")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card, default) or cpu")
    args = ap.parse_args(argv)

    mesh = synth.build_voronoi_mesh(args.synthetic, jitter=0.05)
    raw = synth.solid_body_fields(mesh, n_layers=20)

    app = api.MOPSApp()
    app.init(args.device, precision="fp64")
    app.begin()
    app.add_grid(mesh)
    app.add_solution(1, raw)
    app.end()
    app.active_attribute(1)

    cfg = VisualizationSettings(image_width=args.width,
                                image_height=raw["layerThickness"].shape[1],
                                fixed_latitude=args.lat)
    img = app.run_regrid(cfg)
    imgio.save_image_channels_png(args.out, img, ("east", "north"))
    print(f"wrote fixed-latitude section to {args.out}_*.png")
    return img


if __name__ == "__main__":
    main()
