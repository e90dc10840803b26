"""The native batch WAV decoder, built at first use and bound with ctypes.

Counterpart of ``aum_tpu/data/native.py``'s ``native_available`` and
``decode_wav_batch``. The library is the repository's own
``csrc/wavloader.cpp`` (RIFF/WAVE PCM 8/16/24/32-bit and float32, first
channel, mean-subtracted and zero-padded or cropped, decoded by a pool of
threads), compiled with the host C++ compiler into ``build/aum_tpu_torch/``
under a name that hashes the source and the flags. A failed build raises;
``BatchPipeline(use_native=False)`` is the explicit way to decode in Python
instead. Nothing here runs at import time.

The ffmpeg-backed decoder (``csrc/audiodecode.cpp``) is not ported yet.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Sequence

import numpy as np

REPO = Path(__file__).resolve().parents[2]
SOURCE = REPO / "csrc" / "wavloader.cpp"
BUILD_DIR = REPO / "build" / "aum_tpu_torch"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-pthread", "-shared")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"wavloader-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the decoder unless it is built already; raise with the
    compiler's output if the build fails."""
    path = library_path()
    if path.exists():
        return path
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++ or $CXX) to build the WAV decoder; "
                           "pass use_native=False to decode in Python")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".tmp{os.getpid()}")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {SOURCE.name} failed (rc {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)  # atomic: a concurrent loader never sees half a file
    return path


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    lib.aum_decode_wav_batch.restype = None
    lib.aum_decode_wav_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.c_int]
    return lib


def native_available() -> bool:
    """Build and load the decoder: True, or a failed build raises."""
    _lib()
    return True


def decode_wav_batch(paths: Sequence[str], max_samples: int, threads: int = 8
                     ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Decode a batch of WAVs: (waves (n, max_samples) float32
    mean-subtracted and padded, n_samples (n,) before the crop, sample_rates
    (n,), statuses (n,), 0 where the decode succeeded)."""
    if max_samples <= 0:
        raise ValueError(f"max_samples must be positive, got {max_samples}")
    lib = _lib()
    n = len(paths)
    out = np.zeros((n, max_samples), np.float32)
    n_samples = np.zeros(n, np.int64)
    rates = np.zeros(n, np.int32)
    statuses = np.zeros(n, np.int32)
    arr = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    lib.aum_decode_wav_batch(
        arr, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), max_samples,
        n_samples.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        rates.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        statuses.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), max(1, threads))
    return out, n_samples, rates, statuses
