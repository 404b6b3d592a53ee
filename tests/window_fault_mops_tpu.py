"""Which side mops_tpu's layer-window kernel takes on the ascending-column
lane of ROADMAP §3 (the window-path fault that
tests/test_torch_refscale.py::test_window_step_parts_from_full_step_on_an_ascending_column
pins in the port).  The port's window step flags this lane as a clamp miss
(the cell's first rise lies above the window's start) and repairs it on the
full column, so its window path lands where its full column does, with one
miss counted; mops_tpu's window kernel has no such test, flags nothing and
parts from its full-column step.

Lane 644 of the bench's 3,000-cell L60 crossing-regime case (2,048 seeds,
depths 10..2,500 m) takes one float32 step of 120 s through mops_tpu's
Pallas kernels in interpret mode, full column and layer window, and through
the port's plain full-column and window paths; it prints, per path, the
distance moved, the velocity, the window-miss count, and the window paths'
ratio to their full-column step.  Neighbouring lanes 640-647 are run too as
a control (their window and full steps agree).

    python tests/window_fault_mops_tpu.py

It runs on the CPU and takes minutes, most of them the interpret-mode
compile of mops_tpu's full-column kernel at L60, so it is a script and not
a test.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import bench as jax_bench  # noqa: E402
import mops_tpu as mt  # noqa: E402
import mops_tpu_torch as mtt  # noqa: E402
from mops_tpu_torch import bench  # noqa: E402

LANE = 644
LANES = list(range(640, 648))


def main():
    crossing = bench.CROSSING
    mesh, sol, seeds, cells = jax_bench.build_case(3000, 60, 2048,
                                                   **crossing)
    pmesh, psol, pseeds, pcells = bench.build_case(
        3000, 60, 2048, device="cpu", **crossing)
    assert np.array_equal(seeds, pseeds) and np.array_equal(cells, pcells)
    depths = mtt.seeding.linear_depth_profile(2048, 10, 2500)
    finals = {}
    for w in (False, True):
        cfg = mt.TrajectorySettings(
            delta_t=120, simulation_duration=120, record_t=120,
            particle_depths=np.asarray(depths[LANES]),
            fail_mode=mt.FailMode.ZERO)
        r = mt.run_advection(mesh, sol, seeds[LANES], cells[LANES], cfg,
                             dtype=jnp.float32, use_pallas=True,
                             use_window=w)
        finals["mops_tpu", w] = (np.asarray(r.final_position, np.float64),
                                 np.asarray(r.velocities)[:, -1],
                                 None if r.window_misses is None
                                 else np.asarray(r.window_misses))
        pcfg = mtt.TrajectorySettings(
            delta_t=120, simulation_duration=120, record_t=120,
            particle_depths=np.asarray(depths[LANES]),
            fail_mode=mtt.FailMode.ZERO)
        p = mtt.run_advection(pmesh, psol, pseeds[LANES], pcells[LANES],
                              pcfg, dtype=torch.float32, device="cpu",
                              use_window=w)
        finals["port", w] = (p.final_position.double().numpy(),
                             p.velocities[:, -1].numpy(),
                             None if p.window_misses is None
                             else p.window_misses.numpy())
    s0 = np.asarray(seeds[LANES], np.float64)
    j = LANES.index(LANE)
    for side in ("mops_tpu", "port"):
        full, win = finals[side, False], finals[side, True]
        moved_f = np.linalg.norm(full[0] - s0, axis=1)
        moved_w = np.linalg.norm(win[0] - s0, axis=1)
        gap = np.linalg.norm(win[0] - full[0], axis=1)
        print(f"{side}: lane {LANE}: full column moved {moved_f[j]:.4f} m, "
              f"velocity {full[1][j].tolist()}; window moved "
              f"{moved_w[j]:.4f} m, velocity {win[1][j].tolist()}, misses "
              f"{int(win[2][j])}; window/full {moved_w[j] / moved_f[j]:.6f},"
              f" {gap[j]:.4f} m apart")
        others = [i for i in range(len(LANES)) if i != j]
        print(f"{side}: lanes {[LANES[i] for i in others]}: largest "
              f"window-full gap {gap[others].max():.4f} m")
    for w in (False, True):
        d = np.linalg.norm(finals["mops_tpu", w][0] - finals["port", w][0],
                           axis=1)
        print(f"port vs mops_tpu, {'window' if w else 'full column'}: lane "
              f"{LANE} {d[j]:.4f} m apart, largest over the lanes "
              f"{d.max():.4f} m")


if __name__ == "__main__":
    main()
