"""Run one cell of the benchmark once on this machine's NVIDIA card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The last line of standard output is the
result (one JSON object: correct, attempted, failed, metrics, device, and
with --trace 1 breakdown; the numbers compared with the reference, each
beside its limit, come last, under 'checks', and are the last lines of
standard error too). Without a card, with fewer cards than the cell asks
for, without the port beside it, or with JAX loaded once the window has
closed, it prints no result and exits non-zero.

The port's geometry cache, any extension or Triton cache, the reference's
Laplacians and the traced runs' Chrome traces stay under portbench/
(`.cache/`, `out/`); the port's kernels build into its own `_build/`.
"""

import time

START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "portbench" / ".cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "deepsphere_weather_tpu")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    for var, sub in (("DSW_TPU_CACHE", "geometry"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"
    # the checkout's root, not this script's folder, is where imports
    # start: the harness is the package `portbench`
    sys.path[:] = [str(ROOT)] + [p for p in sys.path
                                 if Path(p or ".").resolve()
                                 != Path(__file__).resolve().parent]
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = {c["name"]: c for c in bench["workloads"]}.get(args.workload)
    if cell is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card only",
              file=sys.stderr)
        return 3
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 3
    try:
        import deepsphere_weather_torch  # noqa: F401
    except ImportError as e:
        print(f"the program under test is not beside the benchmark: {e}",
              file=sys.stderr)
        return 4

    from portbench.harness import run_cell

    result = run_cell(ROOT, args.workload, args.seed, args.seconds,
                      bool(args.trace), device="cuda", start=START)
    loaded = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if loaded:
        print(f"modules the benchmark must not load are loaded: {loaded}",
              file=sys.stderr)
        return 5
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
