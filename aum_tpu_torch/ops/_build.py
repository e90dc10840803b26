"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` becomes its own shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), and each of the
three scan sources also a second one, ``<name>_sliced``, built ungated
(``-DAUM_SCAN_GATED=0``, ``csrc/common.cuh``): the kernels of a scan with
more than 16 states or without z or D. All missing libraries are compiled
at once, one nvcc process per library, at first use.
They land in ``build/aum_tpu_torch/`` at the root of the checkout, named by a
hash of every file in ``csrc/`` and of the flags, so an edited source is
rebuilt and an unchanged one is reused. Nothing here runs at import time.

Target: ``sm_90a`` (Hopper). ``nvcc -Xptxas -v`` output (registers, shared
memory, spills per kernel) is kept beside each library as ``<name>.log``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "aum_tpu_torch"
SOURCES = ("selective_scan", "selective_scan_bwd", "selective_scan_bwd_fused", "conv1d",
           "scan_combine")
# Every library: name -> (its source in csrc/, nvcc's extra flags).
LIBRARIES = {**{name: (name, ()) for name in SOURCES},
             **{f"{name}_sliced": (name, ("-DAUM_SCAN_GATED=0",)) for name in SOURCES[:3]}}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin; the "
                       "CUDA kernels cannot be built")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(p for p in CSRC_DIR.iterdir() if p.is_file()):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_source_hash()}.so"


# Set in a spawned rank (``parallel/launch.py``): the parent built every
# library before the spawn, so a missing one raises instead of starting a
# build that would race the other ranks' in BUILD_DIR.
PREBUILT_ONLY = False


def build_all() -> dict[str, Path]:
    """Compile every kernel library that is not built yet, all in parallel.

    Raises RuntimeError with nvcc's output if any build fails.
    """
    paths = {name: library_path(name) for name in LIBRARIES}
    todo = {name: p for name, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    if PREBUILT_ONLY:
        raise RuntimeError(f"kernel libraries {sorted(todo)} are not built: a spawned rank only "
                           "loads them, so build them (ops._build.build_all) before the spawn")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name, path in todo.items():
        tmp = path.with_suffix(f".tmp{os.getpid()}")
        source, flags = LIBRARIES[name]
        cmd = [nvcc, *NVCC_FLAGS, *flags, "-o", str(tmp), str(CSRC_DIR / f"{source}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failures = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        path = todo[name]
        path.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name}.cu (rc {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, path)  # atomic: a concurrent loader never sees half a file
    if failures:
        raise RuntimeError("\n".join(failures))
    return paths


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name`` (built on first use)."""
    return ctypes.CDLL(str(build_all()[name]))


def kernel_resources(name: str) -> list[dict]:
    """Each kernel instantiation that library ``name`` launches, from its C
    entry ``aum_kernel_info``: blocks per SM by the
    occupancy calculator, resident warps per SM, registers, spill (local)
    bytes and shared memory per block."""
    lib = library(name)
    fn = lib.aum_kernel_info
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                   ctypes.POINTER(ctypes.c_char_p)]
    fn.restype = ctypes.c_int
    rows = []
    for i in range(64):
        info = (ctypes.c_int * 6)()
        kname = ctypes.c_char_p()
        status = fn(i, info, ctypes.byref(kname))
        if status == -1:
            return rows
        if status != 0:
            raise RuntimeError(f"aum_kernel_info({i}) of {name} failed: CUDA error {status}")
        blocks, threads, regs, local, static_smem, dyn_smem = info
        rows.append({"kernel": kname.value.decode(), "blocks_per_sm": blocks,
                     "warps_per_sm": blocks * threads // 32, "threads": threads,
                     "registers": regs, "local_bytes": local,
                     "shared_bytes": static_smem + dyn_smem})
    raise RuntimeError(f"{name} lists more than 64 kernels")


def check_status(status: int, error_string, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(
            f"{what} failed: CUDA error {status} "
            f"({error_string(status).decode()})")


def check_constant(lib: ctypes.CDLL, fn_name: str, value: int) -> None:
    """Raise unless the library's C entry ``fn_name()`` returns ``value``: a
    constant of the kernel that its wrapper assumes."""
    fn = getattr(lib, fn_name)
    fn.restype = ctypes.c_int
    if fn() != value:
        raise RuntimeError(f"{fn_name}() = {fn()} but the wrapper assumes {value}")
