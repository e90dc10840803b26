"""The native batch audio decoders, built at first use and bound with ctypes.

Counterpart of ``aum_tpu/data/native.py``. Two libraries, each the
repository's own source, compiled with the host C++ compiler into
``build/aum_tpu_torch/`` under a name that hashes the source and the flags:

- ``csrc/wavloader.cpp`` (``native_available``, ``decode_wav_batch``):
  RIFF/WAVE PCM 8/16/24/32-bit and float32, first channel, mean-subtracted
  and zero-padded or cropped, decoded by a pool of threads;
- ``csrc/audiodecode.cpp`` (``audio_decoder_available``, ``decode_audio``,
  ``decode_audio_batch``, ``encode_test_audio``): the same contract for any
  format the system's ffmpeg libraries read (flac, m4a, mp3, ogg, wav),
  linked with ``-lavformat -lavcodec -lavutil``; its headers are looked for
  where ``csrc/Makefile`` looks for them.

A failed build raises with the compiler's output (``DecoderUnavailable``
for the ffmpeg decoder: no headers, or a failed compile or link); there is
no silent fallback. ``BatchPipeline(use_native=False)`` is the explicit way
to decode WAVs in Python instead. Nothing here runs at import time.
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
AUDIO_SOURCE = REPO / "csrc" / "audiodecode.cpp"
BUILD_DIR = REPO / "build" / "aum_tpu_torch"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-pthread", "-shared")
AV_LIBS = ("-lavformat", "-lavcodec", "-lavutil")
# Where csrc/Makefile looks for the ffmpeg headers, in its order.
AV_HEADERS = ("/usr/include/x86_64-linux-gnu/libavformat/avformat.h",
              "/usr/include/libavformat/avformat.h")


class DecoderUnavailable(RuntimeError):
    """The ffmpeg-backed decoder cannot be built or loaded on this host."""


def _library_path(source: Path, name: str, flags: Sequence[str]) -> Path:
    h = hashlib.sha256(" ".join(flags).encode())
    h.update(source.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def library_path() -> Path:
    return _library_path(SOURCE, "wavloader", CXX_FLAGS)


def audio_library_path() -> Path:
    return _library_path(AUDIO_SOURCE, "audiodecode", CXX_FLAGS + AV_LIBS)


def _compile(source: Path, path: Path, libs: Sequence[str], error=RuntimeError) -> Path:
    """Compile ``source`` into ``path`` unless it is built already; raise
    ``error`` with the compiler's output if the build fails."""
    if path.exists():
        return path
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise error(f"no C++ compiler (g++ or $CXX) to build {source.name}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".tmp{os.getpid()}")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(source), *libs],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise error(f"building {source.name} failed (rc {proc.returncode}):\n"
                    f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)  # atomic: a concurrent loader never sees half a file
    return path


def build() -> Path:
    """Compile the WAV decoder unless it is built already."""
    return _compile(SOURCE, library_path(), ())


def av_headers() -> str | None:
    """The ffmpeg header ``csrc/Makefile`` would build against, or None."""
    return next((h for h in AV_HEADERS if os.path.exists(h)), None)


def build_audio() -> Path:
    """Compile the ffmpeg-backed decoder unless it is built already; raise
    ``DecoderUnavailable`` without the headers or with the compiler's output."""
    path = audio_library_path()
    if path.exists():
        return path
    if av_headers() is None:
        raise DecoderUnavailable(
            f"no ffmpeg headers ({' or '.join(AV_HEADERS)}): {AUDIO_SOURCE.name} needs the "
            "libavformat, libavcodec and libavutil development files")
    return _compile(AUDIO_SOURCE, path, AV_LIBS, DecoderUnavailable)


_BATCH_ARGTYPES = [
    ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
    ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
    ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int),
    ctypes.POINTER(ctypes.c_int), ctypes.c_int]


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    lib.aum_decode_wav_batch.restype = None
    lib.aum_decode_wav_batch.argtypes = _BATCH_ARGTYPES
    return lib


@functools.cache
def _audio_lib() -> ctypes.CDLL:
    path = build_audio()
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:  # the libav* shared libraries do not resolve
        raise DecoderUnavailable(f"loading {path.name} failed: {e}") from e
    lib.aum_decode_audio.restype = ctypes.c_int
    lib.aum_decode_audio.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int)]
    lib.aum_decode_audio_batch.restype = None
    lib.aum_decode_audio_batch.argtypes = _BATCH_ARGTYPES
    lib.aum_test_encode.restype = ctypes.c_int
    lib.aum_test_encode.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64, ctypes.c_int]
    return lib


def native_available() -> bool:
    """Build and load the WAV decoder: True, or a failed build raises."""
    _lib()
    return True


def audio_decoder_available() -> bool:
    """Build and load the ffmpeg-backed decoder: True, or
    ``DecoderUnavailable`` is raised."""
    _audio_lib()
    return True


def _run_batch(fn, paths: Sequence[str], max_samples: int, threads: int):
    if max_samples <= 0:
        raise ValueError(f"max_samples must be positive, got {max_samples}")
    n = len(paths)
    out = np.zeros((n, max_samples), np.float32)
    n_samples = np.zeros(n, np.int64)
    rates = np.zeros(n, np.int32)
    statuses = np.zeros(n, np.int32)
    arr = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    fn(arr, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), max_samples,
       n_samples.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
       rates.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
       statuses.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), max(1, threads))
    return out, n_samples, rates, statuses


def decode_wav_batch(paths: Sequence[str], max_samples: int, threads: int = 8
                     ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Decode a batch of WAVs: (waves (n, max_samples) float32
    mean-subtracted and padded, n_samples (n,) before the crop, sample_rates
    (n,), statuses (n,), 0 where the decode succeeded)."""
    return _run_batch(_lib().aum_decode_wav_batch, paths, max_samples, threads)


def decode_audio_batch(paths: Sequence[str], max_samples: int, threads: int = 8
                       ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Decode a batch of audio files of any format the ffmpeg libraries
    read; ``decode_wav_batch``'s contract."""
    return _run_batch(_audio_lib().aum_decode_audio_batch, paths, max_samples, threads)


def decode_audio(path: str, max_samples: int) -> tuple[np.ndarray, int, int]:
    """Decode one file: (wave (max_samples,) float32 mean-subtracted and
    padded, n_samples, sample_rate). Raises ``RuntimeError`` if the decode
    fails (the dataset retries another clip) and ``DecoderUnavailable`` if
    the library cannot be built (it does not)."""
    lib = _audio_lib()
    out = np.zeros(max_samples, np.float32)
    n_samples = ctypes.c_int64(0)
    rate = ctypes.c_int(0)
    st = lib.aum_decode_audio(os.fsencode(path),
                              out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                              max_samples, ctypes.byref(n_samples), ctypes.byref(rate))
    if st != 0:
        raise RuntimeError(f"native audio decode failed ({st}): {path}")
    return out, int(n_samples.value), int(rate.value)


def encode_test_audio(path: str, codec: str, samples: np.ndarray, sample_rate: int) -> None:
    """Write a compressed fixture (codec 'flac' or 'aac') with the library's
    own encoder, so that tests and checks ship no binary audio."""
    s = np.ascontiguousarray(samples, np.float32)
    st = _audio_lib().aum_test_encode(os.fsencode(path), codec.encode(),
                                      s.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                                      len(s), sample_rate)
    if st != 0:
        raise RuntimeError(f"test encode failed ({st}): {codec} -> {path}")
