"""Run one cell of the benchmark on this machine's card and print one JSON
line as the last line of standard output:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Exits with 2, printing no result, where torch sees no CUDA card or fewer
cards than the cell asks for: a measurement never falls back to the CPU.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
CACHE = HERE / ".cache"


def process_start() -> float:
    """The process's start on the perf_counter clock (from /proc, to 10 ms;
    the first line of this file where /proc cannot say)."""
    try:
        with open("/proc/self/stat") as f:
            started = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - started / os.sysconf("SC_CLK_TCK")
        return time.perf_counter() - age
    except (OSError, ValueError, IndexError):
        return T0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    t_process = min(process_start(), T0)
    # every build and kernel cache in fixed directories of the checkout
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    sys.path.insert(0, str(HERE.parent))
    with open(HERE.parent / "BENCHMARK.json") as f:
        spec = json.load(f)
    cells = {w["name"]: w for w in spec["workloads"]}
    if args.workload not in cells:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    import torch
    chips = int(cells[args.workload]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"this cell needs {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              f": no measurement", file=sys.stderr)
        return 2
    from benchmark import harness
    harness.execute(args.workload, args.seed, args.seconds,
                    bool(args.trace), t_process, device="cuda", spec=spec)
    return 0


if __name__ == "__main__":
    sys.exit(main())
