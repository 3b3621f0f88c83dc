"""Readings that the limits of a cell's correctness numbers are set from.

    python3 benchmark/calibrate.py --workload flagship.host_env \\
        --seeds 1 2 3 --control --faults frozen_step half_batch altered_action

For each seed, in one process: the program's first iteration at the cell's
own size (set-up and the observed first iteration, no timed window) held
to the reference, as a run of the benchmark holds it; with ``--control``
the reference computed one precision step below the configuration's
(``reference/model.Precision``) put in the program's place; with
``--faults`` the program's first iteration with each fault planted
underneath (``harness/run_cell.plant``). One JSON line per seed and side:
``{"seed", "side", "numbers"}``. The benchmark's own runs do not run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def readings(cell, seed: int, device, control: bool, faults, emit) -> None:
    from benchmark.harness import correct
    from benchmark.harness.run_cell import first_iteration, reference_side, release

    t = time.perf_counter()
    job, cap = first_iteration(cell, seed, device)
    hp = job.hp
    release(job, device)
    ref = reference_side(hp, seed, cap, device)
    emit(seed, "program", correct.numbers(cap, ref, cap["actions"]), time.perf_counter() - t,
         correct.worst_leaves(cap, ref))
    if control:  # given the trajectory the reference is given
        t = time.perf_counter()
        ctl = reference_side(hp, seed, cap, device, lower=True)
        emit(seed, "control", correct.numbers(ctl, ref, correct.own_actions(ctl)),
             time.perf_counter() - t, correct.worst_leaves(ctl, ref))
    del cap
    for fault in faults:
        t = time.perf_counter()
        job, cap = first_iteration(cell, seed, device, fault=fault)
        release(job, device)
        # the reference of this run's own trajectory, as a run would judge it
        ref = reference_side(hp, seed, cap, device)
        emit(seed, fault, correct.numbers(cap, ref, cap["actions"]), time.perf_counter() - t)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--faults", nargs="*", default=[])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from benchmark.harness import spec
    from benchmark.harness.run_cell import forbidden_modules

    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = spec.cell(args.workload)

    def emit(seed, side, numbers, seconds, worst=None):
        print(json.dumps({"cell": args.workload, "seed": seed, "side": side,
                          "seconds": seconds, "numbers": numbers, "worst": worst}), flush=True)

    for seed in args.seeds:
        readings(cell, seed, torch.device(args.device), args.control, args.faults, emit)
    found = forbidden_modules()
    if found:
        print(f"modules of JAX or of the JAX package were loaded: {found}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
