"""Minimal self-contained zarr-v2-compatible chunked array store.

The port's copy of `deepsphere_weather_tpu/data/zarrstore.py` (numpy
only): the zarr v2 directory format (`.zarray` / `.zattrs` / `.zgroup`
JSON metadata, C-order chunks in `<i>.<j>` files), region reads and
writes, append along axis 0, the process-wide LRU of decompressed chunks
and the decompressed-bytes counter. A store written by either package
reads back byte for byte in the other.

- compressors: None (raw) and zlib are pure Python; blosc goes through the
  system libblosc (`native/bloscio.py`, loaded only when a blosc store is
  read or written, so a store without blosc never needs it)
- `s3://`-style URLs go through fsspec, imported only for such a path
- chunks are read one by one in Python; the JAX package's native bulk
  reader (`native/chunkio.cpp`) is not ported
"""

from __future__ import annotations

import json
import math
import os
import shutil
import threading
import zlib
from collections import OrderedDict
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

__all__ = ["ZarrArray", "ZarrGroup", "open_group", "create_group",
           "set_chunk_cache_bytes", "chunk_cache_stats",
           "read_bytes_counter"]


class _ChunkCache:
    """Process-wide LRU of DECOMPRESSED chunks, bounded by bytes.

    Why it exists: the AR training loader reads small time windows
    (~10 steps) from stores chunked {time: 168, node: -1}, so every sample
    read inflates a full multi-MB chunk per variable to use a few percent
    of it. Uncached, the host pipeline measures ~20 samples/s against a
    much faster device step at HEALPix-16. Cached, repeat window reads
    become memcpy.

    Entries are read-only arrays keyed by (store path, chunk index);
    writers invalidate. Thread-safe (loader worker threads share it).
    """

    def __init__(self, max_bytes: int):
        self.max_bytes = int(max_bytes)
        self._d: "OrderedDict[tuple, np.ndarray]" = OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get(self, key):
        with self._lock:
            arr = self._d.get(key)
            if arr is not None:
                self._d.move_to_end(key)
                self.hits += 1
            else:
                self.misses += 1
            return arr

    def put(self, key, arr: np.ndarray):
        nb = arr.nbytes
        if nb > self.max_bytes:
            return
        arr = arr.copy() if not arr.flags.owndata else arr
        arr.setflags(write=False)
        with self._lock:
            old = self._d.pop(key, None)
            if old is not None:
                self._bytes -= old.nbytes
            self._d[key] = arr
            self._bytes += nb
            while self._bytes > self.max_bytes and self._d:
                _, ev = self._d.popitem(last=False)
                self._bytes -= ev.nbytes

    def invalidate(self, key):
        with self._lock:
            old = self._d.pop(key, None)
            if old is not None:
                self._bytes -= old.nbytes

    def clear(self):
        with self._lock:
            self._d.clear()
            self._bytes = 0


_chunk_cache = _ChunkCache(
    int(os.environ.get("DSW_CHUNK_CACHE_BYTES", 512 * 1024 * 1024)))


def set_chunk_cache_bytes(n: int):
    """Resize (0 disables) the process-wide decompressed-chunk cache."""
    _chunk_cache.max_bytes = int(n)
    if n <= 0:
        _chunk_cache.clear()


def chunk_cache_stats() -> Dict:
    return {"hits": _chunk_cache.hits, "misses": _chunk_cache.misses,
            "bytes": _chunk_cache._bytes,
            "max_bytes": _chunk_cache.max_bytes}


# process-wide decompressed-bytes counter (chunk-cache hits excluded):
# measures what actually hit storage + the decompressor, so I/O-heavy
# passes (verification, rechunk) can report their true read volume
_READ_BYTES = [0]


def read_bytes_counter() -> int:
    return _READ_BYTES[0]


def _dtype_to_str(dt: np.dtype) -> str:
    dt = np.dtype(dt)
    if dt.byteorder == "=":
        return ("<" if np.little_endian else ">") + dt.kind + str(dt.itemsize)
    return dt.str


class _FsPath:
    """pathlib-like adapter over an fsspec filesystem.

    Gives the store transparent remote-object-storage support
    (s3:// gs:// memory:// http:// ...) — parity with the reference's
    zarr-on-S3 workflow (reference: tutorials/s3_storage.ipynb, which uses
    s3fs/fsspec mappers). Only the Path operations the store uses are
    implemented.
    """

    def __init__(self, fs, path: str):
        self.fs = fs
        self._p = str(path).rstrip("/")

    @classmethod
    def from_url(cls, url: str) -> "_FsPath":
        try:
            import fsspec
        except ImportError as e:  # pragma: no cover
            raise ImportError(
                f"opening {url!r} requires fsspec (pip install fsspec "
                f"[+ s3fs/gcsfs for the protocol])") from e

        fs, _, (path, *_rest) = fsspec.get_fs_token_paths(url)
        return cls(fs, path)

    def __truediv__(self, other) -> "_FsPath":
        return _FsPath(self.fs, f"{self._p}/{other}")

    def __str__(self) -> str:
        return f"{self.fs.protocol if isinstance(self.fs.protocol, str) else self.fs.protocol[0]}://{self._p}"

    @property
    def name(self) -> str:
        return self._p.rsplit("/", 1)[-1]

    def exists(self) -> bool:
        return self.fs.exists(self._p)

    def is_dir(self) -> bool:
        return self.fs.isdir(self._p)

    def is_file(self) -> bool:
        return self.fs.isfile(self._p)

    def read_text(self) -> str:
        return self.fs.cat_file(self._p).decode()

    def read_bytes(self) -> bytes:
        return self.fs.cat_file(self._p)

    def write_text(self, s: str):
        self.fs.pipe_file(self._p, s.encode())

    def write_bytes(self, b: bytes):
        self.fs.pipe_file(self._p, bytes(b))

    def mkdir(self, parents: bool = False, exist_ok: bool = False):
        self.fs.makedirs(self._p, exist_ok=True)

    def iterdir(self):
        return [_FsPath(self.fs, p)
                for p in self.fs.ls(self._p, detail=False)]

    def rglob(self, pattern: str):
        return [_FsPath(self.fs, p) for p in self.fs.find(self._p)]

    def stat(self):
        import types

        info = self.fs.info(self._p)
        return types.SimpleNamespace(st_size=info.get("size", 0) or 0)

    def rmtree(self):
        self.fs.rm(self._p, recursive=True)


def _as_path(path):
    """Local paths stay pathlib; URLs with a protocol become fsspec-backed."""
    if isinstance(path, (_FsPath, Path)):
        return path
    s = str(path)
    if "://" in s and not s.startswith("file://"):
        return _FsPath.from_url(s)
    return Path(s.removeprefix("file://"))


def _rmtree(path):
    if isinstance(path, _FsPath):
        path.rmtree()
    else:
        shutil.rmtree(path)


class ZarrArray:
    """A chunked n-D array in zarr v2 directory layout."""

    def __init__(self, path):
        self.path = _as_path(path)
        meta = json.loads((self.path / ".zarray").read_text())
        self.shape = tuple(meta["shape"])
        self.chunks = tuple(meta["chunks"])
        self.dtype = np.dtype(meta["dtype"])
        self.fill_value = meta.get("fill_value", 0)
        comp = meta.get("compressor")
        self.compressor = comp["id"] if comp else None
        if self.compressor not in (None, "zlib", "blosc"):
            raise ValueError(f"unsupported compressor {self.compressor!r}")
        # numcodecs.Blosc meta: cname/clevel/shuffle/blocksize (write-side;
        # reads take codec+shuffle from each chunk's own blosc header)
        self._blosc = ({"cname": comp.get("cname", "zstd"),
                        "clevel": int(comp.get("clevel", 3)),
                        "shuffle": int(comp.get("shuffle", 1)),
                        "blocksize": int(comp.get("blocksize", 0))}
                       if self.compressor == "blosc" else None)
        if meta.get("filters"):
            raise ValueError("zarr filters are not supported")
        if meta.get("order", "C") != "C":
            raise ValueError("only C order supported")
        self.attrs = {}
        attrs_path = self.path / ".zattrs"
        if attrs_path.exists():
            self.attrs = json.loads(attrs_path.read_text())

    # ------------------------------------------------------------------
    @classmethod
    def create(cls, path, shape: Sequence[int], chunks: Sequence[int],
               dtype, compressor: Optional[str] = "zlib",
               fill_value=0, attrs: Optional[Dict] = None,
               overwrite: bool = False) -> "ZarrArray":
        path = _as_path(path)
        if path.exists():
            if not overwrite:
                raise FileExistsError(path)
            _rmtree(path)
        path.mkdir(parents=True)
        dt = np.dtype(dtype)
        if compressor is None:
            comp_meta = None
        elif compressor == "zlib":
            comp_meta = {"id": "zlib", "level": 1}
        elif isinstance(compressor, dict):
            comp_meta = dict(compressor)     # raw numcodecs-style meta
        elif isinstance(compressor, str) and (
                compressor == "blosc" or compressor.startswith("blosc:")):
            # "blosc" / "blosc:zstd" / "blosc:lz4" — reference store format
            # (numcodecs.Blosc zstd/lz4, scripts/03c:320-331)
            _, _, cname = compressor.partition(":")
            comp_meta = {"id": "blosc", "cname": cname or "zstd",
                         "clevel": 3, "shuffle": 1, "blocksize": 0}
        else:
            raise ValueError(f"unsupported compressor {compressor!r}")
        meta = {
            "zarr_format": 2,
            "shape": list(int(s) for s in shape),
            "chunks": list(int(c) for c in chunks),
            "dtype": _dtype_to_str(dt),
            "compressor": comp_meta,
            "fill_value": fill_value,
            "order": "C",
            "filters": None,
        }
        (path / ".zarray").write_text(json.dumps(meta, indent=1))
        if attrs:
            (path / ".zattrs").write_text(json.dumps(attrs, indent=1))
        return cls(path)

    # ------------------------------------------------------------------
    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def n_chunks(self) -> Tuple[int, ...]:
        return tuple(math.ceil(s / c) for s, c in zip(self.shape, self.chunks))

    def _chunk_path(self, idx: Tuple[int, ...]) -> Path:
        return self.path / ".".join(str(i) for i in idx)

    def _read_chunk(self, idx: Tuple[int, ...]) -> np.ndarray:
        p = self._chunk_path(idx)
        cshape = self.chunks
        if not p.exists():
            return np.full(cshape, self.fill_value, dtype=self.dtype)
        raw = p.read_bytes()
        if self.compressor == "zlib":
            raw = zlib.decompress(raw)
        elif self.compressor == "blosc":
            from ..native import bloscio
            raw = bloscio.decompress(
                raw, int(np.prod(cshape)) * self.dtype.itemsize)
        out = np.frombuffer(raw, dtype=self.dtype).reshape(cshape).copy()
        _READ_BYTES[0] += out.nbytes
        return out

    def _cache_key(self, idx: Tuple[int, ...]):
        """Local chunks key on (file, mtime, size): rewriting or
        re-creating a store at the same path changes the key, so stale
        entries become unreachable and age out of the LRU — no explicit
        cross-array invalidation needed. Remote (_FsPath) chunks key on
        the path alone (a stat per read would cost a network round-trip);
        same-process writers invalidate explicitly in _write_chunk."""
        p = self._chunk_path(idx)
        if isinstance(p, Path):
            try:
                st = p.stat()
                return (str(p), st.st_mtime_ns, st.st_size)
            except OSError:
                return (str(p), -1, -1)
        return (str(self.path), idx)

    def _write_chunk(self, idx: Tuple[int, ...], data: np.ndarray):
        raw = np.ascontiguousarray(data, dtype=self.dtype).tobytes()
        if self.compressor == "zlib":
            raw = zlib.compress(raw, 1)
        elif self.compressor == "blosc":
            from ..native import bloscio
            raw = bloscio.compress(raw, self.dtype.itemsize, **self._blosc)
        self._chunk_path(idx).write_bytes(raw)
        _chunk_cache.invalidate(self._cache_key(idx))

    # ------------------------------------------------------------------
    def _norm_key(self, key) -> Tuple[slice, ...]:
        if not isinstance(key, tuple):
            key = (key,)
        if Ellipsis in key:
            i = key.index(Ellipsis)
            fill = (slice(None),) * (self.ndim - (len(key) - 1))
            key = key[:i] + fill + key[i + 1:]
        key = key + (slice(None),) * (self.ndim - len(key))
        out = []
        squeeze = []
        for d, (k, s) in enumerate(zip(key, self.shape)):
            if isinstance(k, (int, np.integer)):
                i = int(k) + s if int(k) < 0 else int(k)   # arr[-1] etc.
                k = slice(i, i + 1)
                squeeze.append(d)
            start, stop, step = k.indices(s)
            if step != 1:
                raise ValueError("only contiguous slices supported")
            out.append(slice(start, stop))
        return tuple(out), tuple(squeeze)

    def __getitem__(self, key) -> np.ndarray:
        sel, squeeze = self._norm_key(key)
        out_shape = tuple(s.stop - s.start for s in sel)
        out = np.empty(out_shape, dtype=self.dtype)
        idxs = self._chunks_overlapping(sel)
        for idx, chunk in self._read_chunks_bulk(idxs):
            self._copy(chunk, idx, sel, out, to_out=True)
        if squeeze:
            out = out.reshape(tuple(
                n for d, n in enumerate(out_shape) if d not in squeeze))
        return out

    def _read_chunks_bulk(self, idxs):
        """Read many chunks, decompressed-chunk cache first. Yields
        (idx, chunk)."""
        if _chunk_cache.max_bytes <= 0:
            for i in idxs:
                yield i, self._read_chunk(i)
            return
        for i in idxs:
            key = self._cache_key(i)
            chunk = _chunk_cache.get(key)
            if chunk is None:
                chunk = self._read_chunk(i)
                _chunk_cache.put(key, chunk)
            yield i, chunk

    def __setitem__(self, key, value):
        sel, _ = self._norm_key(key)
        value = np.asarray(value, dtype=self.dtype)
        value = np.broadcast_to(value, tuple(s.stop - s.start for s in sel))
        for idx in self._chunks_overlapping(sel):
            full = all(
                idx[d] * self.chunks[d] >= sel[d].start
                and min((idx[d] + 1) * self.chunks[d], self.shape[d]) <= sel[d].stop
                and self.chunks[d] * (idx[d] + 1) <= self.shape[d]
                for d in range(self.ndim)
            )
            chunk = (np.full(self.chunks, self.fill_value, dtype=self.dtype)
                     if full else self._read_chunk(idx))
            self._copy(chunk, idx, sel, value, to_out=False)
            self._write_chunk(idx, chunk)

    def _chunks_overlapping(self, sel):
        ranges = []
        for d in range(self.ndim):
            c = self.chunks[d]
            first = sel[d].start // c
            last = max((sel[d].stop - 1) // c, first) if sel[d].stop > sel[d].start else first - 1
            ranges.append(range(first, last + 1))
        idxs = [()]
        for r in ranges:
            idxs = [i + (j,) for i in idxs for j in r]
        return idxs

    def _copy(self, chunk, idx, sel, buf, to_out: bool):
        chunk_sl, buf_sl = [], []
        for d in range(self.ndim):
            c0 = idx[d] * self.chunks[d]
            lo = max(sel[d].start, c0)
            hi = min(sel[d].stop, c0 + self.chunks[d], self.shape[d])
            if hi <= lo:
                return
            chunk_sl.append(slice(lo - c0, hi - c0))
            buf_sl.append(slice(lo - sel[d].start, hi - sel[d].start))
        if to_out:
            buf[tuple(buf_sl)] = chunk[tuple(chunk_sl)]
        else:
            chunk[tuple(chunk_sl)] = buf[tuple(buf_sl)]

    # ------------------------------------------------------------------
    def append(self, value: np.ndarray, axis: int = 0):
        """Append along an axis (zarr append semantics; used for time-chunked
        ingest, reference scripts/03c:109-120)."""
        value = np.asarray(value, dtype=self.dtype)
        old = self.shape[axis]
        new_shape = list(self.shape)
        new_shape[axis] = old + value.shape[axis]
        self.resize(new_shape)
        sel = [slice(None)] * self.ndim
        sel[axis] = slice(old, new_shape[axis])
        self[tuple(sel)] = value

    def resize(self, new_shape: Sequence[int]):
        meta = json.loads((self.path / ".zarray").read_text())
        meta["shape"] = [int(s) for s in new_shape]
        (self.path / ".zarray").write_text(json.dumps(meta, indent=1))
        self.shape = tuple(int(s) for s in new_shape)

    def set_attrs(self, attrs: Dict):
        self.attrs.update(attrs)
        (self.path / ".zattrs").write_text(json.dumps(self.attrs, indent=1))

    def __array__(self, dtype=None):
        arr = self[...]
        return arr.astype(dtype) if dtype is not None else arr


class ZarrGroup:
    """A zarr v2 group: a directory of named arrays + attributes."""

    def __init__(self, path):
        self.path = _as_path(path)
        if not (self.path / ".zgroup").exists():
            raise FileNotFoundError(f"not a zarr group: {path}")
        self.attrs = {}
        ap = self.path / ".zattrs"
        if ap.exists():
            self.attrs = json.loads(ap.read_text())

    @classmethod
    def create(cls, path, attrs: Optional[Dict] = None,
               overwrite: bool = False) -> "ZarrGroup":
        path = _as_path(path)
        if path.exists() and overwrite:
            _rmtree(path)
        path.mkdir(parents=True, exist_ok=True)
        (path / ".zgroup").write_text(json.dumps({"zarr_format": 2}, indent=1))
        if attrs:
            (path / ".zattrs").write_text(json.dumps(attrs, indent=1))
        return cls(path)

    def array_names(self):
        return sorted(
            p.name for p in self.path.iterdir()
            if p.is_dir() and (p / ".zarray").exists()
        )

    def __contains__(self, name: str) -> bool:
        return (self.path / name / ".zarray").exists()

    def __getitem__(self, name: str) -> ZarrArray:
        return ZarrArray(self.path / name)

    def create_array(self, name: str, **kwargs) -> ZarrArray:
        return ZarrArray.create(self.path / name, **kwargs)

    def set_attrs(self, attrs: Dict):
        self.attrs.update(attrs)
        (self.path / ".zattrs").write_text(json.dumps(self.attrs, indent=1))


def open_group(path) -> ZarrGroup:
    return ZarrGroup(path)


def create_group(path, attrs=None, overwrite=False) -> ZarrGroup:
    return ZarrGroup.create(path, attrs=attrs, overwrite=overwrite)
