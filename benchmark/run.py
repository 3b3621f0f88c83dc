"""The benchmark of ``eavit_tpu_torch``: PPO+RND training frames per second.

    python3 benchmark/run.py --workload flagship.host_env --seed 7 \\
        --seconds 51 --trace 0

Runs one cell (``benchmark/workloads/<name>.json``) on the card: set-up
(the job built as ``eavit_tpu_torch.train.train`` builds it, weights made
from the seed, the obs-norm warm-up and a first iteration under
observation), whole training iterations for ``--seconds``, and with
``--trace 1`` one more iteration under ``torch.profiler``. Then it frees the
program, holds the first iteration to the plain reference
(``benchmark/reference``) and prints one JSON line: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each compared number and its limit.

Exits with an error and prints no result where there is no card, fewer
cards than the cell asks for, or a module of JAX or of the JAX package was
loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
# one process with few threads: the host's share of an iteration is Python
# and launches, which more threads only make noisier
os.environ.setdefault("OMP_NUM_THREADS", "2")
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_TF", "0")
for _var, _dir in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ.setdefault(_var, str(ROOT / "benchmark" / ".cache" / _dir))


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def result_line(res, metrics_spec, trace: bool, device_name: str, chips: int):
    from benchmark.harness import spec

    data = res["data"]
    metrics = {}
    for m in metrics_spec:
        value = spec.reader(m["name"]).read(data)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": device_name, "count": chips,
              "memory_peak_bytes": int(data.peak_bytes)}
    line = {"correct": bool(res["correct"]), "attempted": data.iterations, "failed": 0,
            "metrics": metrics, "device": device}
    if trace and data.trace is not None:
        device["busy_s"] = data.trace.busy_s()
        device["window_s"] = data.trace.window_s
        ops = sorted(data.trace.time_by_name().items(), key=lambda kv: -kv[1])[:10]
        line["breakdown"] = {"device_ops": [[n[:200], t] for n, t in ops],
                             "idle_gaps": [[n[:200], t] for n, t in data.trace.idle_gaps(10)]}
    # a number that could not be read (a leaf missing, a NaN) prints as 1e300
    line["checks"] = {k: {"value": res["numbers"][k] if math.isfinite(res["numbers"][k])
                          else 1e300, "limit": v}
                      for k, v in res["limits"].items()}
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    torch.set_num_threads(2)
    from benchmark.harness import spec
    from benchmark.harness.run_cell import forbidden_modules, run

    cell = spec.cell(args.workload)
    chips = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        _log(f"{args.workload} needs {chips} CUDA device(s); "
             f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    if chips != 1:
        _log(f"{args.workload}: cells on {chips} cards are not run by this harness yet")
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    res = run(cell, args.seed, args.seconds, bool(args.trace), device, T0, _log)
    found = forbidden_modules()
    if found:
        _log(f"modules of JAX or of the JAX package were loaded: {found}")
        return 3
    _log(f"card: {_power_limit()}")
    line = result_line(res, spec.metrics_of(args.workload, bool(args.trace)),
                       bool(args.trace), torch.cuda.get_device_name(device), chips)
    for k, c in line["checks"].items():
        _log(f"check {k} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
