"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Every source under ``transformer_tts_tpu_torch/csrc/`` is a ``.cu`` file
with a plain C interface (no PyTorch headers), so ``nvcc`` builds each in
seconds; the Hopper design's four sources also link libcuda
(``-lcuda``, for their TMA tensor maps). A library is built at its first use into
``build/torch_kernels/`` at the root of the checkout, under a name that
carries a hash of its source and of the shared headers (``csrc/*.cuh``,
found by ``nvcc`` beside the source), so an edited source or header is
rebuilt and an unchanged one is reused.
Several sources build in parallel: one ``nvcc`` process each, all started
together (:func:`build`).

Nothing here runs at import time; the CPU tests import the package on a
machine with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# libraries a source links beyond the CUDA runtime: the Hopper design
# encodes its TMA tensor maps with libcuda's cuTensorMapEncodeTiled
LINK_FLAGS = {name: ("-lcuda",) for name in (
    "flash_fwd_sm90", "flash_bwd_sm90", "flash_relpos_fwd_sm90",
    "flash_relpos_bwd_sm90")}

_LOADED: Dict[str, ctypes.CDLL] = {}
BUILD_LOGS: Dict[str, str] = {}     # name -> nvcc output (ptxas usage)
BUILD_SECONDS: Dict[str, float] = {}  # name -> wall seconds of its nvcc


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels are built on a machine with "
            "the CUDA toolkit (PATH or /usr/local/cuda/bin)")
    return path


def library_path(name: str) -> Path:
    digest = hashlib.sha256()
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        digest.update(src.read_bytes())
    digest = digest.hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build(names: Iterable[str]) -> Dict[str, Path]:
    """Build the named sources that are not built yet, in parallel.

    Returns name -> library path. Raises ``RuntimeError`` with the
    compiler's output if any build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: library_path(n) for n in names}
    procs = {}
    start = time.perf_counter()
    for name, out in paths.items():
        if out.exists():
            continue
        # build to a private name, then rename: a second process that
        # builds the same source at the same time never sees half a file
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu"),
               *LINK_FLAGS.get(name, ())]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOGS[name] = log
        BUILD_SECONDS[name] = time.perf_counter() - start
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The built library ``name`` (building it first if needed)."""
    lib = _LOADED.get(name)
    if lib is None:
        path = build([name])[name]
        lib = ctypes.CDLL(str(path))
        _LOADED[name] = lib
    return lib
