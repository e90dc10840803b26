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


def _bwd_lib_with(block_channels: int) -> _Lib:
    return _Lib(aum_selective_scan_bwd=lambda *a: 0,
                aum_scan_bwd_error_string=lambda status: b"",
                aum_scan_bwd_state_chunk=lambda: ss.STATE_CHUNK,
                aum_scan_bwd_block_channels=lambda: block_channels)


@pytest.mark.parametrize("block_channels", [ss.BWD_BLOCK_CHANNELS, 16])
def test_bwd_lib_checks_its_block_channels(block_channels, monkeypatch):
    """K2's channels per block size the dB/dC partials the wrapper sums: a
    library built with another value is refused at load."""
    lib = _bwd_lib_with(block_channels)
    monkeypatch.setattr(_build, "library", lambda name: lib)
    if block_channels == ss.BWD_BLOCK_CHANNELS:
        assert ss._bwd_lib.__wrapped__() is lib
    else:
        with pytest.raises(RuntimeError, match="aum_scan_bwd_block_channels"):
            ss._bwd_lib.__wrapped__()


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


@pytest.mark.parametrize("channels,tile,error", [
    (conv.CHANNELS_PER_THREAD, conv.TILE_STEPS, None),
    (4, conv.TILE_STEPS, "aum_conv_channels_per_thread"),
    (conv.CHANNELS_PER_THREAD, 64, "aum_conv_tile_steps")], ids=["same", "channels", "tile"])
def test_conv_lib_checks_its_constants(channels, tile, error, monkeypatch):
    """The conv kernel's channels per thread and steps per tile, from which
    the card's edge checks are sized: a library built with others is refused
    at load."""
    lib = _Lib(aum_causal_conv1d_fwd=lambda *a: 0, aum_conv_error_string=lambda status: b"",
               aum_conv_channels_per_thread=lambda: channels, aum_conv_tile_steps=lambda: tile)
    monkeypatch.setattr(_build, "library", lambda name: lib)
    if error is None:
        assert conv._lib.__wrapped__() is lib
    else:
        with pytest.raises(RuntimeError, match=error):
            conv._lib.__wrapped__()


def _scan_lib_with(max_rank: int, smem: int) -> _Lib:
    return _Lib(**{f"aum_selective_scan_{form}": lambda *a: 0
                   for form in ("dual_fwd", "dual_direct_fwd", "dual_fdt_fwd", "dual_stage_fwd",
                                "fwd")},
                aum_scan_error_string=lambda status: b"",
                aum_scan_state_chunk=lambda: ss.STATE_CHUNK,
                aum_scan_fdt_max_rank=lambda: max_rank,
                aum_scan_fdt_smem_bytes=lambda rank, dtype: smem if rank == max_rank else 0)


@pytest.mark.parametrize("max_rank,smem,error", [
    (ss.MAX_DT_RANK, ss.FDT_SMEM_PER_BLOCK, None),
    (32, ss.FDT_SMEM_PER_BLOCK, "aum_scan_fdt_max_rank"),
    (ss.MAX_DT_RANK, ss.FDT_SMEM_PER_BLOCK + 16, "shared memory")],
    ids=["same", "rank", "smem"])
def test_scan_lib_checks_the_fuse_dt_constants(max_rank, smem, error, monkeypatch):
    """The fuse_dt kernel's largest dt rank (the wrapper refuses larger ones
    before a launch) and its shared memory per block at that rank, which
    must leave room for 4 blocks per SM: a library that differs is refused at
    load."""
    lib = _scan_lib_with(max_rank, smem)
    monkeypatch.setattr(_build, "library", lambda name: lib)
    if error is None:
        assert ss._lib.__wrapped__() is lib
    else:
        with pytest.raises(RuntimeError, match=error):
            ss._lib.__wrapped__()
