"""deepsphere_weather_torch — the PyTorch/CUDA port of deepsphere_weather_tpu.

Spherical weather forecasting with Chebyshev graph convolutions, for one
NVIDIA H100 (sm_90a): HEALPix knn geometry, the block-sparse Laplacian
operator with its hand-written CUDA kernels (`kernels/`), UNetSpherical,
serving, training (also node- and data-parallel) and the train -> predict
-> verify driver `cli/train_predict.py` with its zarr data stack. The JAX
package `deepsphere_weather_tpu` is the reference the port is tested
against; nothing here imports it or JAX.

Entry points default to device="cuda" and never fall back to the CPU;
pass device="cpu" to run the plain PyTorch versions of the kernels.
"""

__version__ = "0.1.0"
