"""Self-contained HEALPix pixelization (numpy, no healpy dependency).

Implements the standard HEALPix sphere tessellation (Gorski et al. 2005):
nested/ring pixel index conversion and pixel-center computation, which is
all the framework needs to build spherical graphs and hierarchical pooling.

Replaces the reference's healpy/pygsp dependency
(reference: modules/utils_models.py:11-20, env dep `healpy`).

Nested ordering is essential: the 4 children of a coarse nested pixel are
contiguous, so hierarchical avg/max pooling is a reshape+reduce
(reference: modules/layers.py:784-941 HealpixMaxPool/AvgPool).
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "nside2npix",
    "npix2nside",
    "pix2ang_nest",
    "pix2ang_ring",
    "nest2ring",
    "ring2nest",
    "healpix_lonlat",
]

# Face constants from the HEALPix specification.
_JRLL = np.array([2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 4], dtype=np.int64)
_JPLL = np.array([1, 3, 5, 7, 0, 2, 4, 6, 1, 3, 5, 7], dtype=np.int64)


def nside2npix(nside: int) -> int:
    """Number of pixels for a given nside."""
    return 12 * nside * nside


def npix2nside(npix: int) -> int:
    nside = int(round(np.sqrt(npix / 12)))
    if 12 * nside * nside != npix:
        raise ValueError(f"{npix} is not a valid HEALPix npix")
    return nside


def _compress_bits(v: np.ndarray) -> np.ndarray:
    """Extract even bits of v (inverse of bit interleave), vectorized."""
    v = v.astype(np.uint64)
    v &= np.uint64(0x5555555555555555)
    v = (v | (v >> np.uint64(1))) & np.uint64(0x3333333333333333)
    v = (v | (v >> np.uint64(2))) & np.uint64(0x0F0F0F0F0F0F0F0F)
    v = (v | (v >> np.uint64(4))) & np.uint64(0x00FF00FF00FF00FF)
    v = (v | (v >> np.uint64(8))) & np.uint64(0x0000FFFF0000FFFF)
    v = (v | (v >> np.uint64(16))) & np.uint64(0x00000000FFFFFFFF)
    return v.astype(np.int64)


def _spread_bits(v: np.ndarray) -> np.ndarray:
    """Spread bits of v into even positions (bit interleave helper)."""
    v = v.astype(np.uint64)
    v = (v | (v << np.uint64(16))) & np.uint64(0x0000FFFF0000FFFF)
    v = (v | (v << np.uint64(8))) & np.uint64(0x00FF00FF00FF00FF)
    v = (v | (v << np.uint64(4))) & np.uint64(0x0F0F0F0F0F0F0F0F)
    v = (v | (v << np.uint64(2))) & np.uint64(0x3333333333333333)
    v = (v | (v << np.uint64(1))) & np.uint64(0x5555555555555555)
    return v.astype(np.int64)


def _nest2xyf(nside: int, ipix: np.ndarray):
    """Nested pixel index -> (x, y, face)."""
    npface = nside * nside
    face = ipix // npface
    pf = ipix % npface
    x = _compress_bits(pf)
    y = _compress_bits(pf >> 1)
    return x, y, face


def _xyf2nest(nside: int, x: np.ndarray, y: np.ndarray, face: np.ndarray):
    return face * (nside * nside) + _spread_bits(x) + (_spread_bits(y) << 1)


def _xyf2ring(nside: int, x: np.ndarray, y: np.ndarray, face: np.ndarray):
    """(x, y, face) -> ring pixel index. Vectorized port of the standard algorithm."""
    nl4 = 4 * nside
    jr = _JRLL[face] * nside - x - y - 1  # ring number counted from north pole, 1-based

    north = jr < nside
    south = jr > 3 * nside

    nr = np.where(north, jr, np.where(south, nl4 - jr, nside))
    # start pixel of the ring
    n_before = np.where(
        north,
        2 * nr * (nr - 1),
        np.where(
            south,
            nside2npix(nside) - 2 * (nr + 1) * nr,
            2 * nside * (nside - 1) + (jr - nside) * nl4,
        ),
    )
    kshift = np.where(north | south, 0, (jr - nside) & 1)

    jp = (_JPLL[face] * nr + x - y + 1 + kshift) // 2
    jp = np.where(jp > nl4, jp - nl4, jp)
    jp = np.where(jp < 1, jp + nl4, jp)
    n_in_ring = np.where(north | south, 4 * nr, nl4)
    return n_before + (jp - 1) % n_in_ring


def nest2ring(nside: int, ipix: np.ndarray) -> np.ndarray:
    ipix = np.asarray(ipix, dtype=np.int64)
    x, y, f = _nest2xyf(nside, ipix)
    return _xyf2ring(nside, x, y, f)


def ring2nest(nside: int, ipix: np.ndarray) -> np.ndarray:
    """Ring pixel index -> nested (via inverse permutation of nest2ring)."""
    npix = nside2npix(nside)
    ring_of_nest = nest2ring(nside, np.arange(npix))
    inv = np.empty(npix, dtype=np.int64)
    inv[ring_of_nest] = np.arange(npix)
    return inv[np.asarray(ipix, dtype=np.int64)]


def pix2ang_nest(nside: int, ipix: np.ndarray):
    """Nested pixel index -> (theta, phi) colatitude/longitude in radians."""
    ipix = np.asarray(ipix, dtype=np.int64)
    x, y, face = _nest2xyf(nside, ipix)
    jr = _JRLL[face] * nside - x - y - 1

    north = jr < nside
    south = jr > 3 * nside
    nr = np.where(north, jr, np.where(south, 4 * nside - jr, nside)).astype(np.float64)

    z = np.where(
        north,
        1.0 - nr * nr / (3.0 * nside * nside),
        np.where(
            south,
            -1.0 + nr * nr / (3.0 * nside * nside),
            (2.0 * nside - jr) * 2.0 / (3.0 * nside),
        ),
    )
    kshift = np.where(north | south, 0, (jr - nside) & 1)

    jp = (_JPLL[face] * nr.astype(np.int64) + x - y + 1 + kshift) / 2.0
    nl4 = 4 * nside
    jp = np.where(jp > nl4, jp - nl4, jp)
    jp = np.where(jp < 1, jp + nl4, jp)

    phi = (jp - (kshift + 1) * 0.5) * (np.pi / (2.0 * nr))
    theta = np.arccos(np.clip(z, -1.0, 1.0))
    return theta, phi


def pix2ang_ring(nside: int, ipix: np.ndarray):
    theta, phi = pix2ang_nest(nside, ring2nest(nside, ipix))
    return theta, phi


def healpix_lonlat(subdivisions: int, nest: bool = True):
    """Pixel-center (lon, lat) in degrees for all pixels.

    Parameters mirror the reference's pygsp `SphereHealpix(subdivisions, nest=True)`
    (reference: scripts/01_define_spherical_samplings.py:21-31).
    lon in [0, 360), lat in [-90, 90].
    """
    nside = int(subdivisions)
    if nside < 1:
        raise ValueError(
            f"HEALPix subdivisions must be >= 1, got {nside} (a 3-level UNet "
            "needs the base sampling at subdivisions >= 4)")
    npix = nside2npix(nside)
    idx = np.arange(npix)
    if nest:
        theta, phi = pix2ang_nest(nside, idx)
    else:
        theta, phi = pix2ang_ring(nside, idx)
    lat = 90.0 - np.rad2deg(theta)
    lon = np.rad2deg(phi) % 360.0
    return lon, lat
