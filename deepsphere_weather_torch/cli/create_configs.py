"""Config-file generator.

Port of `deepsphere_weather_tpu/cli/create_configs.py` (reference:
scripts/07_create_configs.py:78-110, scripts_training/00_create_configs.py):
the configs/ grid,
  configs/UNetSpherical/<SamplingName>/<Pool>Pool-Graph_<graphtype>.json,
for every sampling x pool method x graph type the reference ships (7
samplings x 6 pool methods x {knn, mesh, voronoi}; hierarchical max and
avg pools only on HEALPix and equiangular grids), written with the same
settings and file names as the JAX generator's. Every generated config
builds in the port (`models.get_model`).

Usage:
    python -m deepsphere_weather_torch.cli.create_configs [--out_dir configs] \\
        [--architecture UNetSpherical]
"""

from __future__ import annotations

import copy
from pathlib import Path

from ..config import get_default_settings, write_config_file

# Sampling grid (reference scripts/01_define_spherical_samplings.py:21-31)
SAMPLINGS_400KM = {
    "Healpix_400km": ("healpix", {"subdivisions": 16, "nest": True}),
    "Equiangular_400km": ("equiangular", {"nlat": 36, "nlon": 72}),
    "Equiangular_400km_tropics": ("equiangular", {"nlat": 46, "nlon": 92}),
    "Icosahedral_400km": ("icosahedral", {"subdivisions": 16}),
    "O24": ("gauss", {"nlat": 48, "nlon": "ecmwf-octahedral"}),
    "Cubed_400km": ("cubed", {"subdivisions": 24}),
    "Healpix_100km": ("healpix", {"subdivisions": 64, "nest": True}),
}

POOL_METHODS = ["Max", "Avg", "Interp", "MaxArea", "MaxVal", "Learn"]
GRAPH_TYPES = ["knn", "mesh", "voronoi"]


def create_configs(out_dir="configs", architecture: str = "UNetSpherical",
                   samplings=None) -> int:
    """Write the grid under `out_dir`; returns the number of files."""
    out_dir = Path(out_dir)
    base = get_default_settings()
    base["ar_settings"].update({
        "input_k": [-18, -12, -6], "output_k": [0],
        "forecast_cycle": 6, "ar_iterations": 6,
    })
    base["training_settings"].update({
        "epochs": 15, "learning_rate": 0.007, "training_batch_size": 16,
        "validation_batch_size": 16, "scoring_interval": 30,
        "deterministic_training": True, "seed_model_weights": 10,
        "seed_random_shuffling": 15,
        # the stability and convergence recipe the shipped configs carry:
        # global-norm clipping (at lr 0.007 the RNN strategy's backward
        # diverges at the growth to AR6 without it), each AR stage's
        # plateau judged on its own loss, the final stage trained to
        # convergence
        "gradient_clipping": 1.0,
        "early_stopping_reset_on_growth": "full",
        "ar_scheduler_factor": 0.05,
        "lr_plateau_decay": 0.3,
        "lr_plateau_max_decays": 3,
    })
    n = 0
    for name, (sampling, kwargs) in (samplings or SAMPLINGS_400KM).items():
        for pool in POOL_METHODS:
            # hierarchical max/avg only exist for healpix/equiangular
            if pool in ("Max", "Avg") and sampling not in ("healpix",
                                                           "equiangular"):
                continue
            for gt in GRAPH_TYPES:
                cfg = copy.deepcopy(base)
                cfg["model_settings"].update({
                    "architecture_name": architecture,
                    "sampling_name": name,
                    "sampling": sampling,
                    "sampling_kwargs": kwargs,
                    "pool_method": pool,
                    "graph_type": gt,
                    "knn": 20,
                })
                p = out_dir / architecture / name / f"{pool}Pool-Graph_{gt}.json"
                write_config_file(cfg, p)
                n += 1
    return n


def cli():
    import argparse

    p = argparse.ArgumentParser(description="Generate the configs/ grid")
    p.add_argument("--out_dir", default="configs")
    p.add_argument("--architecture", default="UNetSpherical")
    args = p.parse_args()
    n = create_configs(args.out_dir, architecture=args.architecture)
    print(f"wrote {n} config files under {args.out_dir}/")


if __name__ == "__main__":
    cli()
