"""Build and load the port's CUDA kernels.

Each kernel is one `.cu` file in this directory with a plain C interface.
At first use it is compiled with `nvcc` for `sm_90a` into a shared library
under `kernels/_build/` (git-ignored), named by a hash of its source and
flags so an edited source rebuilds, and loaded with `ctypes`. A plain C
interface keeps PyTorch's headers out of the compile (seconds, not the
minutes a `torch.utils.cpp_extension` build of the same file takes); the
wrappers pass raw device pointers and PyTorch's current stream.

Nothing is built or loaded at import time. A missing `nvcc` or a failed
compile raises: there is no fallback.
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
from typing import Dict

__all__ = ["KernelLibrary", "load_kernel", "BUILD_DIR"]

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


def load_kernel(name: str) -> KernelLibrary:
    """Compile (once per source version) and load `kernels/<name>.cu`."""
    with _lock:
        if name in _loaded:
            return _loaded[name]
        src = _SRC_DIR / f"{name}.cu"
        flags = _ARCH_FLAGS + _FLAGS
        digest = hashlib.sha1(src.read_bytes() + " ".join(flags).encode()
                              ).hexdigest()[:16]
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        so = BUILD_DIR / f"{name}_{digest}.so"
        built, seconds, log = False, 0.0, ""
        if not so.exists():
            cmd = [_nvcc(), *flags]
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            t0 = time.perf_counter()
            try:
                proc = subprocess.run([*cmd, "-o", tmp, str(src)],
                                      capture_output=True, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed building {src.name} "
                        f"(exit {proc.returncode}):\n{proc.stdout}{proc.stderr}")
                # rename into place: a concurrent loader never sees a
                # partial library
                os.replace(tmp, so)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
            seconds = time.perf_counter() - t0
            built, log = True, proc.stdout + proc.stderr
        lib = KernelLibrary(name=name, lib=ctypes.CDLL(str(so)), path=so,
                            built=built, nvcc_seconds=seconds, ptxas_log=log)
        _loaded[name] = lib
        return lib
