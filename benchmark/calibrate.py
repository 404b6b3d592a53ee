"""Readings that the limits in limits/<cell>.json are set from, in one
process on the card:

    python3 benchmark/calibrate.py --workload <cell> --seeds 101 102 ... \
        --control 3 [--out FILE]

For each seed: the cell's set-up for that seed (its fields; no warm-up,
which moves times and not answers), then request 0 of its traffic through
the API, as a run's window sends it, and the comparison numbers of that
request's sample against the float64 reference.  For the first
``--control`` seeds also the control: the reference itself computed in
float32 with TF32 weighted sums (the precision below the configuration's
float32 with TF32 off), held to the float64 reference by the same numbers;
and for the first seed the reference in plain float32, which shows how far
float32 alone reads.  On a card each program row also gives the device
memory peaks of the set-up, the request and the reference.  Prints one
JSON line of all readings (and writes it to ``--out``).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))


def readings(workload: str, seeds, n_control: int, device="cuda",
             shrink=None, mesh_cache=None) -> dict:
    """{"program": [...], "control": [...], "float32": [...]} of numbers
    per seed, with the seconds each part took."""
    import torch

    from benchmark import check, harness, meshgen, reference
    spec = harness.load_spec()
    cuda = device == "cuda"

    def peak():
        """The device memory peak since the last call, in bytes."""
        if not cuda:
            return 0
        value = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        return value

    out = {"workload": workload, "program": [], "control": [], "float32": []}
    for i, seed in enumerate(seeds):
        _, config, mix = harness.cell_of(spec, workload)
        if shrink is not None:
            config, mix = shrink(config, mix)
        run = harness.Run(config, mix, int(seed), torch.device(device))
        peak()
        t0 = time.perf_counter()
        harness.setup(run, mesh_cache or meshgen.CACHE_DIR, warm=False)
        t1 = time.perf_counter()
        peaks = {"setup": peak()}
        job = None if run.kind == "remap" \
            else harness.traffic.trajectory_job(mix, run.seed, 0)
        answer = harness.call(run, 0, job=job)
        run.samples.append(harness.sample(run, 0, answer, job))
        run.sync()
        t2 = time.perf_counter()
        peaks["request"] = peak()
        del answer
        run.app = None
        if cuda:
            torch.cuda.empty_cache()
        mesh, snaps = harness.reference_tables(run)
        want = harness.reference_answers(run, mesh, snaps)
        t3 = time.perf_counter()
        peaks["reference"] = peak()
        del mesh, snaps
        if cuda:
            torch.cuda.empty_cache()
        row = dict(harness.numbers_of(run, want), seed=int(seed),
                   setup_s=t1 - t0, request_s=t2 - t1, reference_s=t3 - t2,
                   peak_bytes=peaks)
        out["program"].append(row)
        print(json.dumps({"program": row}), file=sys.stderr, flush=True)
        for key, ar, n in (("control", reference.CONTROL, n_control),
                           ("float32", reference.Arith(torch.float32), 1)):
            if i < n:
                t4 = time.perf_counter()
                m, s = harness.reference_tables(run, ar)
                got = harness.reference_answers(run, m, s, ar)
                per = [check.image_numbers(g, w) if run.kind == "remap"
                       else check.trajectory_numbers(g, w)
                       for g, w in zip(got, want)]
                row = dict(check.worst(per), seed=int(seed),
                           seconds=time.perf_counter() - t4)
                out[key].append(row)
                print(json.dumps({key: row}), file=sys.stderr, flush=True)
                del m, s, got
        del want, run
        if cuda:
            torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--control", type=int, default=3)
    parser.add_argument("--out")
    args = parser.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    res = readings(args.workload, args.seeds, args.control)
    res["device"] = torch.cuda.get_device_name(0)
    line = json.dumps(res)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
