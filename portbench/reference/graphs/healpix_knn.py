"""The knn graph of a nested HEALPix sampling (`sampling: "healpix"`,
`graph_type: "knn"`): each level's rescaled Laplacian, worked out again
by `reference/sphere.py` and cached as .npz files under the directory
given."""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List

import numpy as np
from scipy import sparse

from portbench.reference.sphere import healpix_nest_xyz, knn_laplacian


def levels(model_settings: Dict, depth: int, cache: Path
           ) -> List[sparse.csr_matrix]:
    """The Laplacians of the `depth` levels nside, nside / 2, ... of the
    UNet, each cached as `ref_lap_healpix_nest<nside>_k<k>.npz`."""
    nside = model_settings["sampling_kwargs"]["subdivisions"]
    k = model_settings["knn"]
    cache.mkdir(parents=True, exist_ok=True)
    out = []
    for lvl in range(depth):
        ns = nside >> lvl
        path = cache / f"ref_lap_healpix_nest{ns}_k{k}.npz"
        if path.exists():
            with np.load(path) as z:
                lap = sparse.csr_matrix((z["data"], z["indices"], z["indptr"]),
                                        shape=tuple(z["shape"]))
        else:
            lap = knn_laplacian(healpix_nest_xyz(ns), k)
            tmp = path.with_name(path.stem + ".tmp.npz")
            np.savez(tmp, data=lap.data, indices=lap.indices,
                     indptr=lap.indptr, shape=np.asarray(lap.shape))
            tmp.replace(path)
        out.append(lap)
    return out
