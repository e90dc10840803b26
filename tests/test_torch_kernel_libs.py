"""The port's kernel libraries as its Python side reads them, on the CPU.

The libraries are built by nvcc on a machine with a card; here a stand-in
for a loaded library holds the constants and the resource table that the C
entries would return, so the checks the wrappers make at load time and the
occupancy reader run without one.
"""

from __future__ import annotations

import importlib

import pytest

from aum_tpu_torch.ops import _build

ss = importlib.import_module("aum_tpu_torch.ops.selective_scan")  # the module, not the op


class _Entry:
    """A C entry point: callable, with the argtypes/restype ctypes sets."""

    def __init__(self, fn):
        self.fn = fn

    def __call__(self, *args):
        return self.fn(*args)


class _Lib:
    def __init__(self, **entries):
        for name, fn in entries.items():
            setattr(self, name, _Entry(fn))


# The two backward libraries: (library, prefix of its C entries, loader,
# the channels per block the wrapper sums dB/dC partials over).
_BWD_LIBS = {"k2": ("selective_scan_bwd", "scan_bwd", "_bwd_lib", ss.BWD_BLOCK_CHANNELS),
             "fused": ("selective_scan_bwd_fused", "scan_bwd_fused", "_bwd_fused_lib",
                       ss.BWD_FUSED_BLOCK_CHANNELS)}


def _bwd_lib_with(prefix: str, block_channels: int) -> _Lib:
    return _Lib(**{f"aum_selective_{prefix}": lambda *a: 0,
                   f"aum_{prefix}_error_string": lambda status: b"",
                   f"aum_{prefix}_state_chunk": lambda: ss.STATE_CHUNK,
                   f"aum_{prefix}_block_channels": lambda: block_channels})


# K2's cases keep the ids they had before the fused library joined them.
@pytest.mark.parametrize("which, built", [
    pytest.param("k2", ss.BWD_BLOCK_CHANNELS, id=str(ss.BWD_BLOCK_CHANNELS)),
    pytest.param("k2", 16, id="16"),
    *(pytest.param("fused", c, id=f"fused-{c}") for c in (ss.BWD_FUSED_BLOCK_CHANNELS, 32, 8))])
def test_bwd_lib_checks_its_block_channels(which, built, monkeypatch):
    """Each backward kernel's channels per block size the dB/dC partials the
    wrapper sums: a library built with another value is refused at load."""
    name, prefix, loader, block_channels = _BWD_LIBS[which]
    lib = _bwd_lib_with(prefix, built)
    monkeypatch.setattr(_build, "library", lambda n: lib if n == name else None)
    load = getattr(ss, loader).__wrapped__
    if built == block_channels:
        assert load() is lib
    else:
        with pytest.raises(RuntimeError, match=f"aum_{prefix}_block_channels"):
            load()


def test_kernel_resources_reads_every_instantiation(monkeypatch):
    table = [(b"scan_dual_fwd_kernel<__nv_bfloat16, false>", (12, 128, 56, 0, 8192, 0)),
             (b"scan_bwd_fused_kernel<float, true>", (3, 64, 168, 8, 0, 75776))]

    def info(i, out, name):
        if i >= len(table):
            return -1
        name._obj.value = table[i][0]  # name is byref(c_char_p), as the C entry gets it
        for k, v in enumerate(table[i][1]):
            out[k] = v
        return 0

    monkeypatch.setattr(_build, "library", lambda name: _Lib(aum_kernel_info=info))
    rows = _build.kernel_resources("selective_scan")
    assert [r["kernel"] for r in rows] == [t[0].decode() for t in table]
    assert rows[0] == {"kernel": "scan_dual_fwd_kernel<__nv_bfloat16, false>",
                       "blocks_per_sm": 12, "warps_per_sm": 48, "threads": 128,
                       "registers": 56, "local_bytes": 0, "shared_bytes": 8192}
    assert rows[1]["warps_per_sm"] == 6 and rows[1]["shared_bytes"] == 75776


def test_kernel_resources_raises_on_a_cuda_error(monkeypatch):
    monkeypatch.setattr(_build, "library",
                        lambda name: _Lib(aum_kernel_info=lambda i, out, name: 98))
    with pytest.raises(RuntimeError, match="CUDA error 98"):
        _build.kernel_resources("selective_scan_bwd")


conv = importlib.import_module("aum_tpu_torch.ops.conv1d")


@pytest.mark.parametrize("channels,tile,width,error", [
    (conv.CHANNELS_PER_THREAD, conv.TILE_STEPS, conv.UNROLLED_WIDTHS, None),
    (4, conv.TILE_STEPS, conv.UNROLLED_WIDTHS, "aum_conv_channels_per_thread"),
    (conv.CHANNELS_PER_THREAD, 64, conv.UNROLLED_WIDTHS, "aum_conv_tile_steps"),
    (conv.CHANNELS_PER_THREAD, conv.TILE_STEPS, 4, "aum_conv_unrolled_widths")],
    ids=["same", "channels", "tile", "width"])
def test_conv_lib_checks_its_constants(channels, tile, width, error, monkeypatch):
    """The conv kernel's channels per thread and steps per tile, from which
    the card's edge checks are sized, and the widest conv with its own
    instantiation (the wrapper counts the general form's launches past it):
    a library built with others is refused at load."""
    lib = _Lib(aum_causal_conv1d_fwd=lambda *a: 0, aum_conv_error_string=lambda status: b"",
               aum_conv_channels_per_thread=lambda: channels, aum_conv_tile_steps=lambda: tile,
               aum_conv_unrolled_widths=lambda: width)
    monkeypatch.setattr(_build, "library", lambda name: lib)
    if error is None:
        assert conv._lib.__wrapped__() is lib
    else:
        with pytest.raises(RuntimeError, match=error):
            conv._lib.__wrapped__()


def _scan_lib_with(whole_rank: int, smem: int, dtypes=(0, 1), ranks=None) -> _Lib:
    """A stand-in scan library whose fuse_dt form holds ranks to
    ``whole_rank`` whole and takes ``smem`` bytes per block at ``ranks``
    (default: that rank and the windowed form's past it) in ``dtypes``."""
    ranks = (whole_rank, whole_rank + 1) if ranks is None else ranks
    return _Lib(**{f"aum_selective_scan_{form}": lambda *a: 0
                   for form in ("dual_fwd", "dual_direct_fwd", "dual_fdt_fwd", "dual_stage_fwd",
                                "fwd")},
                aum_scan_error_string=lambda status: b"",
                aum_scan_state_chunk=lambda: ss.STATE_CHUNK,
                aum_scan_fdt_whole_rank=lambda: whole_rank,
                aum_scan_fdt_smem_bytes=lambda rank, dtype: (
                    smem if rank in ranks and dtype in dtypes else 0))


@pytest.mark.parametrize("whole_rank,smem,error", [
    (ss.FDT_WHOLE_RANK, ss.SMEM_PER_BLOCK, None),
    (32, ss.SMEM_PER_BLOCK, "aum_scan_fdt_whole_rank"),
    (ss.FDT_WHOLE_RANK, ss.SMEM_PER_BLOCK + 16, "shared memory")],
    ids=["same", "rank", "smem"])
def test_scan_lib_checks_the_fuse_dt_constants(whole_rank, smem, error, monkeypatch):
    """The largest dt rank the fuse_dt kernel holds whole (past it, its
    windowed form) and its shared memory per block at that rank and past it
    in fp32 and bf16, which must fit what a block can hold on the card: a
    library that differs is refused at load, the gated one and the sliced
    one alike."""
    lib = _scan_lib_with(whole_rank, smem)
    monkeypatch.setattr(_build, "library", lambda name: lib)
    for loader in (ss._lib, ss._sliced_lib):
        if error is None:
            assert loader.__wrapped__() is lib
        else:
            with pytest.raises(RuntimeError, match=error):
                loader.__wrapped__()


@pytest.mark.parametrize("dtype", [0, 1], ids=["fp32", "bf16"])
def test_scan_lib_checks_the_fuse_dt_smem_in_each_dtype(dtype, monkeypatch):
    """Past what a block holds in one dtype alone is refused too, and in the
    windowed form alone."""
    lib = _scan_lib_with(ss.FDT_WHOLE_RANK, ss.SMEM_PER_BLOCK + 16, dtypes=(dtype,))
    monkeypatch.setattr(_build, "library", lambda name: lib)
    with pytest.raises(RuntimeError, match="shared memory"):
        ss._lib.__wrapped__()
    lib = _scan_lib_with(ss.FDT_WHOLE_RANK, ss.SMEM_PER_BLOCK + 16, dtypes=(dtype,),
                         ranks=(ss.FDT_WHOLE_RANK + 1,))
    monkeypatch.setattr(_build, "library", lambda name: lib)
    with pytest.raises(RuntimeError, match="shared memory"):
        ss._lib.__wrapped__()


def test_sliced_libraries_are_the_scan_sources_built_ungated(tmp_path, monkeypatch):
    """Every source is its own library, and each scan source a second one,
    ``<name>_sliced``, built with -DAUM_SCAN_GATED=0; the sliced backward
    libraries are checked at load as the gated ones are."""
    calls = []

    class _Proc:
        def __init__(self, cmd, **kw):
            calls.append(cmd)
            open(cmd[cmd.index("-o") + 1], "wb").close()
            self.returncode = 0

        def communicate(self):
            return "", None

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "Popen", _Proc)
    paths = _build.build_all()
    assert set(paths) == set(_build.SOURCES) | {f"{n}_sliced" for n in (
        "selective_scan", "selective_scan_bwd", "selective_scan_bwd_fused")}
    by_out = {cmd[cmd.index("-o") + 1]: cmd for cmd in calls}
    for name, path in paths.items():
        cmd = next(c for out, c in by_out.items() if out.startswith(str(path.with_suffix(""))))
        source = name.removesuffix("_sliced")
        assert cmd[-1].endswith(f"csrc/{source}.cu")
        assert ("-DAUM_SCAN_GATED=0" in cmd) == name.endswith("_sliced")
    assert _build.build_all() == paths and len(calls) == len(paths)  # built once
    for which in ("k2", "fused"):
        name, prefix, loader, block_channels = _BWD_LIBS[which]
        lib = _bwd_lib_with(prefix, block_channels)
        monkeypatch.setattr(_build, "library",
                            lambda n, lib=lib, name=name: lib if n == f"{name}_sliced" else None)
        assert getattr(ss, loader).__wrapped__(f"{name}_sliced") is lib
