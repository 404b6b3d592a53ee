"""Building a kernel source of ``csrc/`` into a shared library with nvcc.

Each source is compiled for sm_90a into ``mops_tpu_torch/_build/`` at first
use, cached by the hash of its source and flags, and loaded with ctypes by
its wrapper module.  A source may be split into parts (``-DSTAGE_PART=p``,
p = 1..parts) compiled by parallel nvcc processes and linked into one
library.  Nothing here runs when a module is imported.
"""

from __future__ import annotations

import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

from ..utils.timer import TimerManager

BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
# IEEE division and square root are required by the step kernels (see
# csrc/stage_kernel.cu): no fast-math.  No implicit contraction into fused
# multiply-adds either (-fmad=false): the compiler contracts an expression
# by its context, so the window kernels and the full-column ones would round
# the same arithmetic differently; the kernels' sums call fma() explicitly.
# ptxas reports each kernel's registers and spills into the build log.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is not None:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                           "mops_tpu_torch/csrc/ at first use")
    return found


def build_library(source: Path, stem: str, parts: int = 1) -> tuple[Path, str]:
    """Compile ``source`` (cached by source and flags) and return (library
    path, build log with ptxas's register/spill report).  With ``parts`` > 1
    one nvcc process per part is started at once, then one link.  The log
    is kept beside the library and read back on a cache hit.  The recorder
counts each call as ``kernels.compiled`` or ``kernels.cached``."""
    key = hashlib.sha1(source.read_bytes() + " ".join(NVCC_FLAGS).encode()
                       + str(parts).encode()).hexdigest()[:16]
    lib_path = BUILD_DIR / f"lib{stem}_{key}.so"
    log_path = lib_path.with_suffix(".log")
    if lib_path.exists():
        TimerManager.instance().add("kernels.cached")
        return lib_path, (log_path.read_text() if log_path.exists() else "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{key}.{os.getpid()}"
    objs = [BUILD_DIR / f"{stem}_{tag}.{p}.o" for p in range(1, parts + 1)]
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    exe = nvcc()
    procs = []
    try:
        for p, obj in enumerate(objs, start=1):
            part = [f"-DSTAGE_PART={p}"] if parts > 1 else []
            procs.append(subprocess.Popen(
                [exe, *NVCC_FLAGS, *part, "-c", "-o", str(obj), str(source)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        logs = []
        for proc in procs:
            out, err = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {source.name} "
                                   f"({proc.returncode}):\n{err}")
            logs.append(out + err)
        link = subprocess.run([exe, *NVCC_FLAGS[:2], "-shared", "-o",
                               str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed on {source.name} "
                               f"({link.returncode}):\n{link.stderr}")
        log = (f"built {lib_path.name} in {time.perf_counter() - t0:.1f} s "
               f"({parts} part{'s' if parts > 1 else ''} in parallel)\n"
               + "".join(logs))
        log_path.write_text(log)
        os.replace(tmp, lib_path)
        TimerManager.instance().add("kernels.compiled")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for path in (*objs, tmp):
            path.unlink(missing_ok=True)
    return lib_path, log


_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
_PROPS = re.compile(r"Function properties for (\w+)")
_SPILL = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")
# kernel name and template arguments inside a mangled entry name: the
# anonymous namespace's length-prefixed name, I, the dtype (f or d), then
# optional integer (Li<n>E) and bool (Lb<n>E) arguments
_MANGLED = re.compile(r"\d+([a-z_]+_kernel)I([fd])((?:L[ib]\d+E)*)E")


def ptxas_report(log: str) -> dict:
    """{kernel label: {"registers", "stack", "spill_stores", "spill_loads"}}
    from the ptxas lines of a build log.  A label is the kernel's
    name, its dtype and its integer template arguments, e.g.
    ``window_pathline_kernel f32 8``."""
    report, entry, mangled, props = {}, None, None, None
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            mangled = name = m.group(1)
            mm = _MANGLED.search(name)
            if mm:
                args = re.findall(r"L[ib](\d+)E", mm.group(3))
                name = " ".join([mm.group(1), "f32" if mm.group(2) == "f"
                                 else "f64", *args])
            entry = report.setdefault(name, {})
            continue
        if entry is None:
            continue
        m = _PROPS.search(line)
        if m:
            props = m.group(1)
            continue
        m = _SPILL.search(line)
        if m and props == mangled:
            entry.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                         spill_loads=int(m.group(3)))
        m = _REGS.search(line)
        if m:
            entry["registers"] = int(m.group(1))
    return report
