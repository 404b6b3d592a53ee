"""The row-gather probe (K5, mops_tpu_torch.kernels.row_gather) on the CPU:
its plain version against a numpy transcription of the TPU probe
prof_dma.py, the wrapper's checks, and imports that build nothing.

prof_dma.py runs its TPU kernel when it is imported, so it is transcribed
here, not imported: block b of B ids copies the rows table[ids[b*B + j]],
j < B, end to end into VMEM and writes their first 1,024 values
(prof_dma.py:24, ``rows[pl.ds(0, 1024)]``); block 0's head is the first
1,024 values of row ids[0] when a row holds at least 1,024 values
(prof_dma.py:38-40).  The CUDA kernel itself is held to the plain version
on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mops_tpu_torch import prof_dma
from mops_tpu_torch.kernels import nvcc_build, row_gather
from mops_tpu_torch.kernels.row_gather import (HEAD, row_gather_plain,
                                               row_gather_probe)

REPO = Path(__file__).resolve().parents[1]


def _inputs(n_rows, F, n, dtype, seed=0):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(n_rows, F)).astype(dtype)
    ids = rng.integers(0, n_rows, size=(n,)).astype(np.int32)
    return table, ids


def _prof_dma_numpy(table, ids, B):
    """prof_dma.py:6-24 in numpy: per block, the B rows end to end, its
    head (the (8, 128) output block, flattened) and, beside it, the float64
    sum of everything the block brought into VMEM."""
    flat = table.reshape(-1)
    KF = table.shape[1]
    heads, sums = [], []
    for b in range(len(ids) // B):
        rows = np.concatenate([flat[c * KF:(c + 1) * KF]
                               for c in ids[b * B:(b + 1) * B]])
        heads.append(rows[:HEAD])
        sums.append(rows.astype(np.float64).sum())
    return np.stack(heads), np.array(sums)


@pytest.mark.parametrize("B", [4, 16])
@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("F", [1280, 320], ids=["F>=1024", "F<1024"])
def test_plain_matches_prof_dma_transcription(F, dtype, B):
    table, ids = _inputs(97, F, 8 * B, dtype)
    head, sums = row_gather_plain(torch.as_tensor(table), torch.as_tensor(ids),
                                  B, chunk_rows=3 * B)
    want_head, want_sums = _prof_dma_numpy(table, ids, B)
    assert head.dtype == torch.from_numpy(table).dtype
    np.testing.assert_array_equal(head.numpy(), want_head)
    scale = np.abs(table[ids].reshape(len(ids) // B, -1)).astype(
        np.float64).sum(1)
    np.testing.assert_array_less(np.abs(sums.numpy() - want_sums),
                                 1e-12 * scale)
    if F >= HEAD:                                  # prof_dma.py:38-40
        np.testing.assert_array_equal(head[0].numpy(),
                                      table.reshape(-1)[ids[0] * F:
                                                        ids[0] * F + HEAD])
    else:                                          # the head spans rows
        assert not np.array_equal(head[0, F:2 * F].numpy(), table[ids[0]])
        np.testing.assert_array_equal(head[0, F:2 * F].numpy(),
                                      table[ids[1]])


def test_wrapper_takes_the_plain_version_on_cpu():
    table, ids = _inputs(50, 256, 64, np.float32, seed=3)
    t, i = torch.as_tensor(table), torch.as_tensor(ids)
    before = row_gather_probe.launches
    got = row_gather_probe(t, i, 16)
    want = row_gather_plain(t, i, 16)
    assert row_gather_probe.launches == before          # no kernel launch
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert row_gather._lib is None


@pytest.mark.parametrize("case", ["n_mod_b", "negative_id", "id_too_large",
                                  "misaligned_row", "short_block",
                                  "int64_ids"])
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    table = torch.zeros((10, 256), dtype=torch.float32)
    ids = torch.zeros(32, dtype=torch.int32)
    B = 16
    if case == "n_mod_b":
        ids = torch.zeros(30, dtype=torch.int32)
    elif case == "negative_id":
        ids[5] = -1
    elif case == "id_too_large":
        ids[7] = 10
    elif case == "misaligned_row":
        table = torch.zeros((10, 258), dtype=torch.float32)  # 1,032 B
    elif case == "short_block":
        B = 2                                          # 512 < 1,024 values
    elif case == "int64_ids":
        ids = ids.long()
    err = TypeError if case == "int64_ids" else ValueError
    with pytest.raises(err):
        row_gather_probe(table, ids, B)


def test_out_of_range_ids_are_caught_after_a_checked_call():
    """A tensor checked once and changed in place is checked again."""
    table = torch.zeros((10, 256), dtype=torch.float32)
    ids = torch.zeros(32, dtype=torch.int32)
    row_gather_probe(table, ids, 16)
    ids[3] = 11
    with pytest.raises(ValueError, match="outside"):
        row_gather_probe(table, ids, 16)


def test_vertex_slot_ids_take_valid_slots_in_order():
    vids = torch.tensor([[4, 5, 6, 0], [7, 8, 9, 1], [2, 3, 0, 0]],
                        dtype=torch.int32)
    nv = torch.tensor([3, 4, 2], dtype=torch.int32)
    ids, dropped = prof_dma.vertex_slot_ids(vids, nv, 4)
    assert ids.tolist() == [4, 5, 6, 7, 8, 9, 1, 2]
    assert dropped == 1 and ids.dtype == torch.int32


def test_modules_import_without_nvcc():
    """Importing the probe and the step kernels builds nothing and needs no
    nvcc; a build without one raises."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("CUDA_HOME", "CUDA_PATH")}
    env["PATH"] = os.path.dirname(sys.executable)
    code = (
        "import mops_tpu_torch.prof_dma, mops_tpu_torch.kernels.row_gather "
        "as rg, mops_tpu_torch.kernels.stage_kernel as sk\n"
        "assert rg._lib is None and sk._lib is None\n"
        "import shutil\n"
        "if shutil.which('nvcc') is None:\n"
        "    try:\n"
        "        rg.build()\n"
        "    except RuntimeError as e:\n"
        "        assert 'nvcc' in str(e)\n"
        "    else:\n"
        "        raise SystemExit('built without nvcc')\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


def test_ptxas_report_parses_registers_and_spills():
    log = (
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_122window_pathline_kernelIfLi8EEEvPKT_' for "
        "'sm_90a'\n"
        "ptxas info    : Function properties for "
        "_ZN12_GLOBAL__N_122window_pathline_kernelIfLi8EEEvPKT_\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 96 registers, used 0 barriers\n"
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_122streamline_step_kernelIdEEvPKT_' for 'sm_90a'\n"
        "ptxas info    : Function properties for some_device_function\n"
        "    8 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads\n"
        "ptxas info    : Function properties for "
        "_ZN12_GLOBAL__N_122streamline_step_kernelIdEEvPKT_\n"
        "    536 bytes stack frame, 248 bytes spill stores, 900 bytes spill "
        "loads\n"
        "ptxas info    : Used 80 registers\n")
    rep = nvcc_build.ptxas_report(log)
    assert rep == {
        "window_pathline_kernel f32 8": {"stack": 0, "spill_stores": 0,
                                         "spill_loads": 0, "registers": 96},
        "streamline_step_kernel f64": {"stack": 536, "spill_stores": 248,
                                       "spill_loads": 900, "registers": 80}}
