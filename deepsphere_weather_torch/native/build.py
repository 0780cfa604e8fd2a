"""Build and load the port's host libraries (C++, g++).

Each library is one `.cpp` file in this directory with a plain C
interface. At first use it is compiled with `g++` into a shared library
under `native/_build/` (git-ignored), named by a hash of the source, the
flags and the compiler (its `--version` and the target `-march=native`
resolves to, so a build from another host or compiler is never loaded),
and loaded with `ctypes`.

Processes that start at once (test workers, spawned ranks) take an
exclusive `flock` on the build directory's lock file around the check and
the build; the compiler writes a temporary file that is renamed into
place, so no process loads a partial library. A missing `g++` or a failed
compile raises with the compiler's output: there is no Python path to fall
back to. Nothing is built or loaded at import time.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict

__all__ = ["load_library", "BUILD_DIR", "CXX"]

_SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = _SRC_DIR / "_build"
CXX = "g++"
_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]
# link flags per library (the JAX package's native/build.py)
_LINK = {"geometry": [], "chunkio": ["-lz", "-lpthread", "-ldl"]}

# name -> the library loaded in this process
_loaded: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _run(cmd):
    try:
        return subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f"C++ compiler {cmd[0]!r} not found: the port's "
                           "host libraries are built with g++") from e


@functools.lru_cache(maxsize=None)
def _toolchain(cxx: str) -> str:
    """What the build depends on besides the source: the compiler's
    version and the target options `-march=native` resolves to here (asked
    once per process)."""
    out = []
    for cmd in ([cxx, "--version"], [cxx, *_FLAGS, "-Q", "--help=target"]):
        proc = _run(cmd)
        if proc.returncode != 0:
            raise RuntimeError(f"{' '.join(cmd)} failed (exit "
                               f"{proc.returncode}):\n{proc.stdout}"
                               f"{proc.stderr}")
        out.append(proc.stdout)
    return "\n".join(out)


def _library_path(name: str, toolchain: str) -> Path:
    digest = hashlib.sha1((_SRC_DIR / f"{name}.cpp").read_bytes())
    digest.update(" ".join(_FLAGS + _LINK[name]).encode())
    digest.update(toolchain.encode())
    return BUILD_DIR / f"libdsw_{name}_{digest.hexdigest()[:16]}.so"


def load_library(name: str) -> ctypes.CDLL:
    """Compile `native/<name>.cpp` once per source, flags and toolchain,
    and load it."""
    with _lock:
        if name in _loaded:
            return _loaded[name]
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        so = _library_path(name, _toolchain(CXX))
        with open(BUILD_DIR / f"{name}.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if not so.exists():
                fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
                os.close(fd)
                try:
                    cmd = [CXX, *_FLAGS, str(_SRC_DIR / f"{name}.cpp"),
                           "-o", tmp, *_LINK[name]]
                    proc = _run(cmd)
                    if proc.returncode != 0:
                        raise RuntimeError(
                            f"g++ failed building {name}.cpp (exit "
                            f"{proc.returncode}):\n{' '.join(cmd)}\n"
                            f"{proc.stdout}{proc.stderr}")
                    os.replace(tmp, so)
                finally:
                    if os.path.exists(tmp):
                        os.unlink(tmp)
        _loaded[name] = ctypes.CDLL(str(so))
        return _loaded[name]
