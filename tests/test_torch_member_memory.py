"""Memory of the port's member (DeepEnsemble) train step against its
single step, with and without remat.

The JAX package's member step holds what M single steps hold: the
`memory_analysis().temp_size_in_bytes` of its compiled steps (flagship
UNetSpherical at HEALPix-4, full widths, knn 20, fp32, AR6, batch 4;
`make_train_step` / `make_member_train_step`) read 99.3, 27.9, 198.3 and
55.8 MiB for the single step, the single step with remat, 2 members and
2 members with remat: members / single 2.00 with and without remat, and
remat cuts the member step to 0.28 of itself. (At HEALPix-8: 327.7, 72.9,
654.0, 145.5 MiB.)

The port counts differently, so it is held to the ratios: the peak of
live storage that one step allocates, counted by a `TorchDispatchMode`
that adds every new storage an operator returns and puts a
`weakref.finalize` on it, after one warm-up step. The same flagship and
shapes, M = 2, seeded weights (`weights.seeded_params`) and a numpy
batch. Bars: member / single <= 2.25 with and without remat, and the
member step with remat <= 0.6 of the member step without. A member step
that takes its gradients with `torch.func.grad` under `vmap` keeps every
AR iteration's backward (and every recompute) alive until it returns: it
read 3.29 and 6.78 member / single, and 1.11 with remat over without.
"""

import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402
from torch.utils._pytree import tree_leaves  # noqa: E402

from deepsphere_weather_torch.data.ar import ARIndexer  # noqa: E402
from deepsphere_weather_torch.engine import (  # noqa: E402
    Adam,
    AreaWeights,
    make_member_train_step,
    make_train_step,
)
from deepsphere_weather_torch.models import MemberStack, UNetSpherical  # noqa: E402
from deepsphere_weather_torch.weights import params_from_jax, seeded_params  # noqa: E402

SUBDIV, KNN, AR, BATCH, M = 4, 20, 6, 4, 2
F_DYN, F_BC, F_STATIC, INPUT_K = 2, 1, 4, (-3, -2, -1)
MEMBERS_BAR, REMAT_BAR = 2.25, 0.6


class LiveStorage(TorchDispatchMode):
    """Bytes of the storages that operators return while the mode is on
    and that are still alive (`live`), and the most of it (`peak`)."""

    def __init__(self):
        super().__init__()
        self.live = self.peak = 0
        self.seen = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            s = t.untyped_storage()
            key, n = s.data_ptr(), s.nbytes()
            if n and key not in self.seen:
                self.seen.add(key)
                self.live += n
                self.peak = max(self.peak, self.live)
                weakref.finalize(s, self._free, key, n)
        return out

    def _free(self, key, n):
        self.seen.discard(key)
        self.live -= n


def _step_peak(step):
    """MiB of live storage at the peak of one step, after a first."""
    step()
    with LiveStorage() as mode:
        step()
    return mode.peak / 2 ** 20


def _params(model, seed):
    tree = seeded_params(model, seed)
    for block in tree.values():
        if isinstance(block, dict) and "rezero_weight" in block:
            block["rezero_weight"] *= 0.1
    return params_from_jax(tree)


@pytest.fixture(scope="module")
def peaks():
    n = 12 * SUBDIV ** 2
    info = {"input_n_feature": F_STATIC + F_BC + F_DYN,
            "output_n_feature": F_DYN, "input_n_time": len(INPUT_K),
            "output_n_time": 1,
            "input_shape_info": {"dynamic": {"node": n}},
            "output_shape_info": {"dynamic": {"node": n}}}
    model = UNetSpherical(info, "healpix",
                          {"subdivisions": SUBDIV, "nest": True}, knn=KNN,
                          pool_method="max", increment_learning=True,
                          numeric_precision="float32", device="cpu").train()
    members = [_params(model, 30 + m) for m in range(M)]
    indexer = ARIndexer.build(list(INPUT_K), [0], 1, AR)
    area_w = AreaWeights(model.geometry.samplings[0], device="cpu")
    w = np.ones(AR + 1, np.float32)
    rng = np.random.default_rng(32)
    W = indexer.window_size
    batch = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
             for k, s in (("dynamic", (BATCH, W, n, F_DYN)),
                          ("bc", (BATCH, W, n, F_BC)),
                          ("static", (n, F_STATIC)))}
    out = {}
    for remat in (False, True):
        model.load_state_dict(members[0])
        single = make_train_step(model, indexer,
                                 Adam(model.parameters(), lr=1e-3),
                                 AR + 1, remat=remat)
        out["single", remat] = _step_peak(lambda: single(batch, w, area_w))
        stack = MemberStack.from_states(model, members)
        step = make_member_train_step(
            stack, indexer, Adam(stack.parameters(), lr=1e-3,
                                 member_axis=True), AR + 1, remat=remat)
        out["members", remat] = _step_peak(lambda: step(batch, w, area_w))
    return out


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_members_cost_about_m_single_steps(peaks, remat):
    ratio = peaks["members", remat] / peaks["single", remat]
    assert peaks["single", remat] > 0
    assert ratio <= MEMBERS_BAR, (
        f"{M} members {peaks['members', remat]:.1f} MiB, single "
        f"{peaks['single', remat]:.1f} MiB: {ratio:.2f}x (bar {MEMBERS_BAR})")


def test_remat_cuts_the_member_step_as_the_single_step(peaks):
    ratio = peaks["members", True] / peaks["members", False]
    single = peaks["single", True] / peaks["single", False]
    assert ratio <= REMAT_BAR, (
        f"member step with remat {peaks['members', True]:.1f} MiB, without "
        f"{peaks['members', False]:.1f} MiB: {ratio:.2f}x (bar {REMAT_BAR}; "
        f"the single step {single:.2f}x)")
