#!/usr/bin/env python3
"""Which part of the card's backward gives unequal bits in a repeat
(ROADMAP.md Queue 3, fault 7). Run from the root of a checkout on a machine
with one NVIDIA GPU and the CUDA toolkit:

    python3 trace_determinism.py [--repeats 6]

For each attention route (``pallas_qkv``, ``pallas``, ``pallas_stream``) and
compute dtype (float32, bfloat16) it runs the loss and backward of
``chip_smoke.grad_check`` (the flagship network on 8 frames, kernel dropout
at rate 0.1 with fixed seed words) ``--repeats`` times in one process, the
caching allocator's free memory filled with NaN bytes or random bytes
before each run, and records:

- every repeat's reading against a copy of the network on the CPU (the
  plain versions): the gradient's relative error and the loss's error;
- every kernel output of each repeat (K1f, K1b, K2f, K2b, ... as the route
  runs them), bit for bit against the first repeat's;
- every parameter's gradient, bit for bit against the first repeat's.

Then it runs the same cases in four more processes, two as they are and two
with ``torch.use_deterministic_algorithms(True)`` (``warn_only``, so that an
op with no deterministic form is named instead of raising),
``torch.backends.cudnn.deterministic`` and ``CUBLAS_WORKSPACE_CONFIG=:4096:8``,
and compares the first repeat of each with this process's, bit for bit. One
JSON line per case and comparison; the last line says which parameters'
gradients differ in each setting.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import warnings

ROUTES = ("pallas_qkv", "pallas", "pallas_stream")
DTYPES = ("float32", "bfloat16")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--repeats", type=int, default=6)
    p.add_argument("--child", help="write this process's first repeats to this file")
    p.add_argument("--deterministic", action="store_true",
                   help="torch.use_deterministic_algorithms and cuDNN's deterministic mode")
    return p.parse_args(argv)


def run_cases(torch, cs, mods, dev, repeats: int, cpu_reference: bool):
    """Every (route, dtype): the repeats' readings and what differs between
    them; with the first repeat's gradients and kernel outputs."""
    results, first = {}, {}
    for attention in ROUTES:
        for dtype in DTYPES:
            case = f"{attention} {dtype}"
            agent = cs.grad_agent(torch, dev, attention, dtype)
            host = cs.host_batch(torch, 8)
            ref = None
            if cpu_reference:  # the same weights: both agents start from chip_smoke.SEED
                ref = cs.network_grads(torch, cs.grad_agent(torch, "cpu", attention, dtype),
                                       host, mods)
                ref_flat = torch.cat([g.reshape(-1) for g in ref[1].values()])
            runs, readings = [], []
            for r in range(repeats):
                cs.poison_allocator(torch, dev, (0xFF, None)[r % 2])
                runs.append(cs.network_grads(torch, agent, host, mods))
                if ref is not None:
                    flat = torch.cat([g.float().reshape(-1).cpu() for g in runs[-1][1].values()])
                    readings.append(dict(
                        grad_rel_err=((flat - ref_flat).norm() / ref_flat.norm()).item(),
                        loss_err=abs(runs[-1][0].item() - ref[0].item())))
            res = cs.compare_repeats(torch, runs)
            results[case] = dict(res, readings=readings, params=len(runs[0][1]))
            loss, grads, calls = runs[0]
            first[case] = dict(loss=loss.cpu(), grads={k: g.cpu() for k, g in grads.items()},
                               calls=[(n, tuple(t.cpu() for t in outs)) for n, outs in calls])
            del agent, runs
            torch.cuda.empty_cache()
    return results, first


def compare_first(torch, cs, a, b):
    """Two processes' first repeats: what differs, as ``compare_repeats``."""
    out = {}
    for case in a:
        runs = [(a[case]["loss"], a[case]["grads"], a[case]["calls"]),
                (b[case]["loss"], b[case]["grads"], b[case]["calls"])]
        res = cs.compare_repeats(torch, runs)
        out[case] = dict(res, params_differing=sorted(res["params_differing"].items(),
                                                      key=lambda kv: -kv[1])[:8],
                         n_params_differing=len(res["params_differing"]))
    return out


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.deterministic:
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    if not torch.cuda.is_available():
        print("trace_determinism: no CUDA device; this script runs on a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke as cs
    from eavit_tpu_torch.ops import _build
    from eavit_tpu_torch.ops import flash as fl
    from eavit_tpu_torch.ops import flash_dropout as fd
    from eavit_tpu_torch.ops import flash_qkv as fq
    from eavit_tpu_torch.ops import flash_stream as fs
    from eavit_tpu_torch.ops import fused_ffn as ff

    mods = (fq, ff, fl, fd, fs)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.deterministic:
        torch.use_deterministic_algorithms(True, warn_only=True)
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    dev = torch.device("cuda")
    _build.build_all()

    if args.child:
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            results, first = run_cases(torch, cs, mods, dev, args.repeats, False)
            caught = sorted({str(x.message).split("\n")[0][:200] for x in w})
        torch.save(dict(results=results, first=first, warnings=caught), args.child)
        return 0

    card = cs.gpu_name_power()
    cs.log("device", nvidia_smi=card, torch=torch.__version__, cuda=torch.version.cuda)
    t0 = time.perf_counter()
    results, first = run_cases(torch, cs, mods, dev, args.repeats, True)
    for case, res in results.items():
        cs.log("in_process", case=case, repeats=args.repeats,
               **{k: (sorted(v.items(), key=lambda kv: -kv[1])[:8]
                      if k == "params_differing" else v) for k, v in res.items()},
               n_params_differing=len(res["params_differing"]))
    summary = {"in_process": {c: len(r["params_differing"]) for c, r in results.items()}}

    with tempfile.TemporaryDirectory() as tmp:
        children = {}
        for tag, det in (("plain_a", False), ("plain_b", False), ("det_a", True),
                         ("det_b", True)):
            path = os.path.join(tmp, f"{tag}.pt")
            cmd = [sys.executable, os.path.abspath(__file__), "--child", path,
                   "--repeats", str(max(2, args.repeats // 2))] + ["--deterministic"] * det
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
            cs.check(proc.returncode == 0, f"child {tag}: {proc.stderr[-2000:]}")
            children[tag] = torch.load(path, weights_only=False)
            for case, res in children[tag]["results"].items():
                cs.log("child_in_process", child=tag, case=case,
                       kernels_differing=res["kernels_differing"],
                       n_params_differing=len(res["params_differing"]),
                       grad_spread=res["grad_spread"], loss_equal=res["loss_equal"])
            if children[tag]["warnings"]:
                cs.log("child_warnings", child=tag, warnings=children[tag]["warnings"])
            summary[f"{tag} in process"] = {c: len(r["params_differing"])
                                            for c, r in children[tag]["results"].items()}
        children["main"] = {"first": first}  # this process
        for a, b in (("main", "plain_a"), ("plain_a", "plain_b"), ("det_a", "det_b"),
                     ("plain_a", "det_a")):
            cmp = compare_first(torch, cs, children[a]["first"], children[b]["first"])
            for case, res in cmp.items():
                cs.log("across_processes", pair=f"{a} vs {b}", case=case, **res)
            summary[f"{a} vs {b}"] = {c: r["n_params_differing"] for c, r in cmp.items()}
    cs.log("summary", seconds=time.perf_counter() - t0,
           params_with_unequal_gradient_bits=summary)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
