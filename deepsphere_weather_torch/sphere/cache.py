"""Disk cache for build-time geometry (the prepared Laplacians).

Same location, file naming and key scheme as the JAX package's
`sphere/cache.py` (`$DSW_TPU_CACHE`, else `~/.cache/deepsphere_weather_tpu`;
file `<sha1(key)[:16]>_arrays.npz`), so the two stacks read and write the
same `lap_v2_*` files.
"""

from __future__ import annotations

import hashlib
import os
import zipfile
from pathlib import Path
from typing import Callable, Dict

import numpy as np

__all__ = ["cache_dir", "cached_arrays"]


def cache_dir() -> Path:
    d = os.environ.get("DSW_TPU_CACHE")
    if d is None:
        d = os.path.join(os.path.expanduser("~"), ".cache", "deepsphere_weather_tpu")
    p = Path(d)
    p.mkdir(parents=True, exist_ok=True)
    return p


def _key_path(key: str, suffix: str) -> Path:
    h = hashlib.sha1(key.encode()).hexdigest()[:16]
    return cache_dir() / f"{h}_{suffix}.npz"


def cached_arrays(key: str,
                  builder: Callable[[], Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    path = _key_path(key, "arrays")
    if path.exists():
        try:
            with np.load(path) as z:
                return {k: z[k] for k in z.files}
        except (OSError, EOFError, ValueError, zipfile.BadZipFile):
            # a file another process is still writing in place (the JAX
            # package's writer does not rename): rebuild it
            pass
    out = builder()
    # write-then-rename: a concurrent reader never sees a partial file
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.npz")
    np.savez_compressed(tmp, **out)
    os.replace(tmp, path)
    return out
