"""The yardstick's arithmetic on a HEALPix-4 stand-in, by hand."""

from standin import REPO
from portbench import counts, harness

ARCH = harness.find(REPO, "reference/arch", "UNetSpherical")
GRAPH = harness.find(REPO, "reference/graphs", "healpix_knn")


def test_forward_flops_by_hand():
    nodes, nnz, B, K = [192, 48, 12], [1000, 300, 100], 2, 3
    f = counts.forward_flops(*ARCH.layers(21, 2), B, K, nodes, nnz)
    convs = [(0, 21, 64), (0, 64, 128), (1, 128, 192), (1, 192, 256),
             (2, 256, 512), (2, 512, 256), (1, 512, 256), (1, 256, 128),
             (0, 256, 128), (0, 128, 64), (0, 64, 2)]
    projs = [(0, 21, 128), (1, 128, 256), (1, 512, 128), (0, 256, 64),
             (0, 64, 2)]
    gemm = sum(2 * B * nodes[l] * K * a * b for l, a, b in convs)
    proj = sum(2 * B * nodes[l] * a * b for l, a, b in projs)
    lap = sum(2 * nnz[l] * B * min(a, b) * (K - 1) for l, a, b in convs)
    assert f == {"gemm": gemm, "projection": proj, "laplacian": lap,
                 "total": gemm + proj + lap}


def test_laplacian_least_time_by_hand(tmp_path):
    (L,) = GRAPH.levels({"sampling_kwargs": {"subdivisions": 4}, "knn": 8},
                        1, tmp_path)
    n, nnz, m = L.shape[0], L.nnz, 32
    t = counts.laplacian_least_s(n, nnz, m, "fp32", "fp32")
    assert t == max((nnz * 8 + 2 * n * m * 4) / 3.35e12,
                    2 * nnz * m / 67e12)
    tb = counts.laplacian_least_s(n, nnz, m, "bf16", "bf16")
    assert tb == max((nnz * 6 + 2 * n * m * 2) / 3.35e12,
                     2 * nnz * m / 989e12)
