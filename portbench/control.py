"""The readings the limits of `correct` are set from, for one cell, over
several seeds in one process (the benchmark's own runs do not run this):

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \
        [--seconds 5] [--device cuda]

For each seed, one JSON line with the numbers of `checks` read three ways
against the fp32 reference on the same inputs:
- `program`: the program, as a run reads it (its set-up steps; for
  forecasts a short window at the cell's load and its seeded sample);
- `control`: the reference in the program's place, computed in the
  configuration's `control_precision` (one step below its own);
- the kind's planted faults (`fault_readings`): for training,
  `fault_half_batch`, the reference in the program's place on the first
  half of each batch, its mean over that half; for forecasts,
  `fault_repeated_lead`, the program's forecasts with one lead replaced
  by the lead before it.
"""

import argparse
import gc
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--controls", type=int, default=3,
                    help="seeds (the first ones) that also read the "
                         "control and the fault")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--root", default=str(ROOT))
    args = ap.parse_args(argv)
    os.environ.setdefault("DSW_TPU_CACHE",
                          str(ROOT / "portbench" / ".cache" / "geometry"))
    sys.path[:] = [str(ROOT)] + [p for p in sys.path
                                 if Path(p or ".").resolve()
                                 != Path(__file__).resolve().parent]
    import torch

    from portbench import harness
    from portbench.workload import run_window

    root = Path(args.root)
    ld = harness.load_cell(root, args.workload)
    prec = ld["config"]["control_precision"]
    device = torch.device(args.device)
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        work = harness.setup_program(root, ld, seed, device)
        setup = work.setup_units(int(ld["traffic"]["check_units"]))
        if work.checks_window:
            run_window(work, args.seconds)
        prog = work.program_readings(setup, seed)
        work.free()
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        t_prog = time.perf_counter() - t
        make_net = harness.reference_net(
            work, harness.reference_geometry(work, root))
        harness.prepare_reference_mode()
        t = time.perf_counter()
        ref = work.reference_readings(setup, make_net)
        t_ref = time.perf_counter() - t
        line = {"seed": seed, "program": work.compare(prog, ref)}
        if i < args.controls:
            line["control"] = work.compare(
                work.reference_readings(setup, make_net, prec), ref)
            line.update(work.fault_readings(setup, make_net, prog, ref))
        line.update(program_s=t_prog, reference_s=t_ref)
        print(json.dumps(line), flush=True)
        del work, prog, ref
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
