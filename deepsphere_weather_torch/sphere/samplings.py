"""Spherical sampling definitions (numpy; the port's own copy).

Mirrors `deepsphere_weather_tpu/sphere/samplings.py` for the HEALPix
family. The other families (equiangular, icosahedral, cubed, gauss) raise
`NotImplementedError` until they are ported.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, Optional

import numpy as np

from .healpix import healpix_lonlat

__all__ = [
    "Sampling",
    "build_sampling",
    "coarsen_sampling_kwargs",
    "check_sampling",
    "check_conv_type",
    "check_pool_method",
    "check_skip_connection",
    "VALID_SAMPLINGS",
]

VALID_SAMPLINGS = ("healpix", "equiangular", "icosahedral", "cubed", "gauss")


@dataclasses.dataclass(frozen=True)
class Sampling:
    """A spherical sampling: pixel centers + identity metadata."""

    name: str                 # one of VALID_SAMPLINGS
    kwargs: tuple             # canonicalized (key, value) pairs -> hashable cache key
    lon: np.ndarray           # degrees, [0, 360)
    lat: np.ndarray           # degrees, [-90, 90]

    @property
    def n_nodes(self) -> int:
        return int(self.lon.shape[0])

    @property
    def coords_3d(self) -> np.ndarray:
        """Unit-sphere xyz coordinates, shape (n_nodes, 3)."""
        lon = np.deg2rad(self.lon)
        lat = np.deg2rad(self.lat)
        return np.stack(
            [np.cos(lat) * np.cos(lon), np.cos(lat) * np.sin(lon), np.sin(lat)],
            axis=1,
        )

    @property
    def kwargs_dict(self) -> Dict:
        return dict(self.kwargs)

    def cache_key(self) -> str:
        """Same key as the JAX package, so both stacks share cache files."""
        def short(v):
            if isinstance(v, tuple) and len(v) > 8:
                h = hashlib.sha1(repr(v).encode()).hexdigest()[:12]
                return f"seq{len(v)}-{h}"
            return v
        items = "_".join(f"{k}-{short(v)}" for k, v in sorted(self.kwargs))
        return f"{self.name}_{items}"


def _canon_kwargs(kwargs: Dict) -> tuple:
    def canon(v):
        if isinstance(v, (list, tuple, np.ndarray)):
            return tuple(int(x) for x in np.asarray(v).ravel())
        return v
    return tuple(sorted((str(k), canon(kwargs[k])) for k in kwargs))


def build_sampling(name: str, sampling_kwargs: Dict) -> Sampling:
    name = check_sampling(name)
    if name != "healpix":
        raise NotImplementedError(
            f"sampling {name!r} is not ported yet (healpix only)")
    kwargs = {k: v for k, v in sampling_kwargs.items() if k not in ("k", "lap_type")}
    lon, lat = healpix_lonlat(**kwargs)
    return Sampling(name=name, kwargs=_canon_kwargs(kwargs), lon=lon, lat=lat)


def coarsen_sampling_kwargs(name: str, sampling_kwargs: Dict, coarsening: int) -> Dict:
    """Graph coarsening rule (HEALPix: subdivisions // coarsening)."""
    name = check_sampling(name)
    if name != "healpix":
        raise NotImplementedError(
            f"sampling {name!r} is not ported yet (healpix only)")
    kw = dict(sampling_kwargs)
    kw["subdivisions"] = kw["subdivisions"] // coarsening
    return kw


def check_sampling(sampling: str) -> str:
    if not isinstance(sampling, str):
        raise TypeError("'sampling' must be a string")
    s = sampling.lower()
    if s not in VALID_SAMPLINGS:
        raise ValueError(f"'sampling' must be one of {VALID_SAMPLINGS}, got {sampling!r}")
    return s


def check_conv_type(conv_type: str, sampling: Optional[str] = None) -> str:
    if not isinstance(conv_type, str):
        raise TypeError("'conv_type' must be a string")
    c = conv_type.lower()
    if c not in ("graph", "image"):
        raise ValueError("'conv_type' must be 'graph' or 'image'")
    if c == "image" and sampling is not None and check_sampling(sampling) != "equiangular":
        raise ValueError("conv_type='image' is only valid for sampling='equiangular'")
    return c


def check_pool_method(pool_method: str) -> str:
    if not isinstance(pool_method, str):
        raise TypeError("'pool_method' must be a string")
    p = pool_method.lower()
    valid = ("max", "avg", "interp", "maxval", "maxarea", "learn")
    if p not in valid:
        raise ValueError(f"'pool_method' must be one of {valid}, got {pool_method!r}")
    return p


def check_skip_connection(skip_connection) -> str:
    if skip_connection is None:
        skip_connection = "none"
    if not isinstance(skip_connection, str):
        raise TypeError("'skip_connection' must be a string")
    s = skip_connection.lower()
    if s not in ("none", "stack", "sum", "avg"):
        raise ValueError("'skip_connection' must be one of none/stack/sum/avg")
    return s
