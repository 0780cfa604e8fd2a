"""deepsphere_weather_torch — the PyTorch/CUDA port of deepsphere_weather_tpu.

Spherical weather forecasting with Chebyshev graph convolutions, for one
NVIDIA H100 (sm_90a): the healpix, equiangular, icosahedral, cubed and
gauss samplings with knn, voronoi and mesh Laplacians and every pool
(`sphere/`, `ops/pool.py`), the block-sparse Laplacian operator with its
hand-written CUDA kernels (`kernels/`), UNetSpherical and the variant
architectures (`models.get_model`), serving from `torch.export` artifacts (single and member-stacked
ensembles; `cli/export_model.py`, `cli/serve.py`), training (also node-
and data-parallel, with BatchNorm, or for DeepEnsemble members in one
step), the train -> predict -> verify driver `cli/train_predict.py` with
its zarr data stack, `cli/predict.py`, and probabilistic forecasting
(`prob/`: SWAG, `bn_update`, ensemble rollouts and stores;
`cli/finetune_swag.py`; `verif/probabilistic.py`). The JAX
package `deepsphere_weather_tpu` is the reference the port is tested
against; nothing here imports it or JAX.

Entry points default to device="cuda" and never fall back to the CPU;
pass device="cpu" to run the plain PyTorch versions of the kernels.
"""

__version__ = "0.1.0"
