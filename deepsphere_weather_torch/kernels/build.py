"""Build and load the port's CUDA kernels.

Each kernel is one `.cu` file in this directory with a plain C interface;
the sources share the `.cuh` headers beside them. At first use a source is
compiled with `nvcc` for `sm_90a` into a shared library under
`kernels/_build/` (git-ignored), named by a hash of the source, the headers
and the flags so that an edited source or header rebuilds, and loaded with
`ctypes`. A plain C
interface keeps PyTorch's headers out of the compile (seconds, not the
minutes a `torch.utils.cpp_extension` build of the same file takes); the
wrappers pass raw device pointers and PyTorch's current stream.

Nothing is built or loaded at import time. A missing `nvcc` or a failed
compile raises: there is no fallback. `load_kernels` starts one `nvcc`
per source that needs a build, all at once, and waits for them together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Sequence

__all__ = ["KernelLibrary", "load_kernel", "load_kernels", "BUILD_DIR"]

_SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = _SRC_DIR / "_build"
_ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
          "-Xptxas", "-v"]


@dataclass
class KernelLibrary:
    """A loaded kernel library and how it was obtained."""

    name: str
    lib: ctypes.CDLL
    path: Path
    built: bool           # False: loaded from an earlier build in BUILD_DIR
    nvcc_seconds: float   # 0.0 when loaded from an earlier build
    ptxas_log: str        # nvcc's -Xptxas -v report (registers, smem, spills)


_loaded: Dict[str, KernelLibrary] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("CUDA toolkit not found (no CUDA_HOME, no nvcc on "
                           "PATH): the port's kernels are built with nvcc")
    nvcc = Path(CUDA_HOME) / "bin" / "nvcc"
    if not nvcc.exists():
        raise RuntimeError(f"nvcc not found at {nvcc}")
    return str(nvcc)


def _library_path(name: str) -> Path:
    """The build of `name`, named by a hash of its source, of every header
    beside it (a source may include any of them) and of the flags."""
    digest = hashlib.sha1((_SRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(_SRC_DIR.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(_ARCH_FLAGS + _FLAGS).encode())
    return BUILD_DIR / f"{name}_{digest.hexdigest()[:16]}.so"


def load_kernels(names: Sequence[str]) -> List[KernelLibrary]:
    """Compile (once per source version) and load `kernels/<name>.cu` for
    each name; the missing builds run side by side."""
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        builds = {}
        for name in dict.fromkeys(names):
            so = _library_path(name)
            if name in _loaded or so.exists():
                continue
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [_nvcc(), *_ARCH_FLAGS, *_FLAGS, "-o", tmp,
                   str(_SRC_DIR / f"{name}.cu")]
            builds[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, so, time.perf_counter())
        done = {}
        try:
            for name, (proc, tmp, so, t0) in builds.items():
                log = proc.communicate()[0]
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed building {name}.cu (exit "
                                       f"{proc.returncode}):\n{log}")
                # rename into place: a concurrent loader never sees a
                # partial library
                os.replace(tmp, so)
                done[name] = (time.perf_counter() - t0, log)
        finally:
            for proc, tmp, _, _ in builds.values():
                proc.kill()
                proc.wait()
                if os.path.exists(tmp):
                    os.unlink(tmp)
        for name in names:
            if name not in _loaded:
                so = _library_path(name)
                seconds, log = done.get(name, (0.0, ""))
                _loaded[name] = KernelLibrary(
                    name=name, lib=ctypes.CDLL(str(so)), path=so,
                    built=name in done, nvcc_seconds=seconds, ptxas_log=log)
        return [_loaded[name] for name in names]


def load_kernel(name: str) -> KernelLibrary:
    """`load_kernels` for one name."""
    return load_kernels([name])[0]
