"""ctypes binding of the parallel chunk reader (`native/chunkio.cpp`).

The port's copy of `deepsphere_weather_tpu/native/chunkio.py`: reads and
decompresses (raw, zlib, or blosc through the system libblosc, which the
C++ side opens with dlopen) many zarr chunk files on a thread pool into
one contiguous numpy buffer, with no Python per chunk. The library is
built at first use (`native/build.py`); a failed build raises, and so
does a blosc read on a machine without libblosc, as the per-chunk Python
path does.
"""

from __future__ import annotations

import ctypes
import os
from typing import List

import numpy as np

__all__ = ["read_chunks"]

# codec ids shared with chunkio.cpp
_CODECS = {None: 0, "zlib": 1, "blosc": 2}


def _lib():
    from .build import load_library

    lib = load_library("chunkio")
    fn = lib.dsw_read_chunks
    fn.restype = ctypes.c_longlong
    fn.argtypes = [
        ctypes.POINTER(ctypes.c_char_p),  # paths
        ctypes.c_longlong,                # n
        ctypes.c_longlong,                # chunk_bytes
        ctypes.c_int32,                   # codec
        ctypes.POINTER(ctypes.c_ubyte),   # out
        ctypes.POINTER(ctypes.c_ubyte),   # status (1 = missing)
        ctypes.c_int32,                   # n_threads
    ]
    return lib


def read_chunks(paths: List[str], out: np.ndarray, compressor,
                fill_value=0) -> int:
    """Fill out[i] (out: [n, *chunk_shape], C-contiguous) from the chunk
    file paths[i]; a row whose file is absent is set to `fill_value` (the
    reader reports the absence itself: no check/read race). `compressor`
    is the store's codec: None, "zlib" or "blosc". Returns the number of
    chunk files read."""
    codec = _CODECS[compressor]
    if compressor == "blosc":
        from . import bloscio

        if not bloscio.available():
            raise RuntimeError(
                "blosc-compressed chunk but libblosc is not available "
                "(install the c-blosc shared library)")
    n = len(paths)
    if n == 0:
        return 0
    if not out.flags["C_CONTIGUOUS"] or out.shape[0] != n:
        raise ValueError(f"out must be C-contiguous with {n} rows, got "
                         f"shape {out.shape}")
    lib = _lib()
    arr = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    status = np.zeros(n, dtype=np.uint8)
    # a pool sized to the CPUs this process may run on: oversubscription
    # on a small host is slower than inflating on one thread
    n_threads = max(1, min(len(os.sched_getaffinity(0)), n, 16))
    rc = lib.dsw_read_chunks(
        arr, n, out.nbytes // n, codec,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        n_threads)
    if rc < 0:
        raise IOError(f"native chunk read failed with code {rc}")
    for i in np.nonzero(status)[0]:
        out[i].fill(fill_value)
    return n - int(status.sum())
