"""ctypes binding to the system c-blosc library (libblosc.so.1).

The port's copy of `deepsphere_weather_tpu/native/bloscio.py`. Blosc is
the codec the reference writes its zarr stores with (zstd / lz4 through
numcodecs.Blosc); c-blosc is the C library numcodecs wraps, so chunks
round-trip byte for byte. Optional: `data/zarrstore.py` imports this
module only for a blosc store, and `available()` says whether the
library loads on this machine.

Only the thread-safe ``*_ctx`` entry points are used — no global
blosc_init()/blosc_destroy() state, safe from loader worker threads.
"""

from __future__ import annotations

import ctypes
from typing import Optional

__all__ = ["available", "compress", "decompress", "decompressed_size"]

_LIB = None
_TRIED = False

#: numcodecs.Blosc shuffle constants (byte shuffle is the numcodecs default)
NOSHUFFLE, SHUFFLE, BITSHUFFLE = 0, 1, 2

_CNAMES = ("blosclz", "lz4", "lz4hc", "snappy", "zlib", "zstd")


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    for name in ("libblosc.so.1", "libblosc.so", "libblosc.1.dylib",
                 "libblosc.dylib"):
        try:
            lib = ctypes.CDLL(name)
        except OSError:
            continue
        try:
            lib.blosc_compress_ctx.restype = ctypes.c_int
            lib.blosc_compress_ctx.argtypes = [
                ctypes.c_int, ctypes.c_int, ctypes.c_size_t, ctypes.c_size_t,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
                ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int]
            lib.blosc_decompress_ctx.restype = ctypes.c_int
            lib.blosc_decompress_ctx.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
                ctypes.c_int]
            lib.blosc_cbuffer_sizes.restype = None
            lib.blosc_cbuffer_sizes.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t),
                ctypes.POINTER(ctypes.c_size_t),
                ctypes.POINTER(ctypes.c_size_t)]
        except AttributeError:
            continue
        _LIB = lib
        break
    return _LIB


def available() -> bool:
    return _load() is not None


def decompressed_size(data: bytes) -> int:
    """Uncompressed byte count recorded in a blosc buffer header."""
    lib = _load()
    if lib is None:
        raise RuntimeError("libblosc is not available on this system")
    if len(data) < 16:
        raise ValueError("buffer too short to be a blosc chunk")
    nbytes = ctypes.c_size_t()
    cbytes = ctypes.c_size_t()
    blocksize = ctypes.c_size_t()
    lib.blosc_cbuffer_sizes(data, ctypes.byref(nbytes),
                            ctypes.byref(cbytes), ctypes.byref(blocksize))
    return int(nbytes.value)


def decompress(data: bytes, nbytes: Optional[int] = None) -> bytes:
    """Decompress one blosc buffer (codec/shuffle are read from its
    header). `nbytes` may pass the expected decompressed size; when
    omitted it is read from the header."""
    lib = _load()
    if lib is None:
        raise RuntimeError(
            "blosc-compressed chunk but libblosc is not available "
            "(install the c-blosc shared library)")
    if nbytes is None:
        nbytes = decompressed_size(data)
    out = ctypes.create_string_buffer(nbytes)
    rc = lib.blosc_decompress_ctx(data, out, nbytes, 1)
    if rc != nbytes:
        raise ValueError(f"blosc decompress failed (rc={rc}, "
                         f"expected {nbytes} bytes)")
    return out.raw


def compress(data: bytes, typesize: int, cname: str = "zstd",
             clevel: int = 3, shuffle: int = SHUFFLE,
             blocksize: int = 0) -> bytes:
    """Compress bytes into one blosc buffer (numcodecs.Blosc-compatible;
    reference stores use cname zstd/lz4, scripts/03c:320-331)."""
    lib = _load()
    if lib is None:
        raise RuntimeError(
            "writing blosc-compressed chunks requires libblosc "
            "(install the c-blosc shared library)")
    if cname not in _CNAMES:
        raise ValueError(f"unknown blosc cname {cname!r}; one of {_CNAMES}")
    if not 0 <= int(shuffle) <= 2:
        raise ValueError(f"blosc shuffle must be 0/1/2, got {shuffle}")
    typesize = max(1, int(typesize))
    # blosc guarantees success with BLOSC_MAX_OVERHEAD = 16 spare bytes
    dst = ctypes.create_string_buffer(len(data) + 16)
    rc = lib.blosc_compress_ctx(int(clevel), int(shuffle), typesize,
                                len(data), data, dst, len(data) + 16,
                                cname.encode(), int(blocksize), 1)
    if rc <= 0:
        raise ValueError(f"blosc compress failed (rc={rc})")
    return dst.raw[:rc]
