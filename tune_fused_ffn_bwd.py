#!/usr/bin/env python3
"""Build variants of K2, the fused FFN, and time them on one GPU.

Two modes. **Backward** (the default): a variant is
``eavit_tpu_torch/csrc/fused_ffn_bwd.cu`` with a number of row slices of its
weight-gradient kernel (``"slices"``; the wrapper's default, 33, if it names
none); it is held to the plain backward (1e-4 of each output's maximum in
float32; in bf16 1.2e-2 for dx and 2e-3 for the rest) and timed at the
flagship minibatch (50,688 rows of D = 256, Hd = 1024) in float32 and bf16
and at the stacked one (100,864 rows, float32), rate 0.1. With ``"abi":
"parent"`` a variant ``{"csrc": DIR}`` is called through the C interface of
the CUDA-core K2b (no bf16 plane scratch, 32-row dx tiles).

**Forward** (first argument ``fwd``): a variant is
``eavit_tpu_torch/csrc/fused_ffn.cu``, optionally with integer constants of
the fused K2f replaced (``{"kFStages": 1}``: the weight ring's stages); it is
held to the plain forward (1e-4 of the output's scale in float32, one bf16
rounding in bf16) and timed at the act rows (12,672 and 25,216, float32),
the minibatch (50,688, float32 and bf16) and the act rows in bf16, rate 0.1.
With ``"abi": "parent"`` a variant ``{"csrc": DIR}`` is called through the
C interface of the CUDA-core K2f (no weight-plane scratch); with
``"ieee_gelu": true`` the fused kernel's GELU takes an IEEE division in
place of ``__fdividef``.

A forward variant with ``"probe": true`` is built with ``clock64`` probes
in the fused kernel (lane 0 of each warp adds the cycles of each phase of
a chunk to a device counter) and prints, at 50,688 rows in both dtypes,
the cycles per block by phase (LayerNorm, waits for a stage, fc1 with the
GELU it is pipelined with, fc2, the syncs, the copy issue, the epilogue)
instead of being timed. Then every variant but the parent's is called
``repeats`` times (default 20) at row counts that leave the last 64-row
block partial (1,001, 1,584: the gradient check's 8 frames, 3,144: four
patch-4 frames) in both dtypes at rates 0 and 0.1; the script prints how
many distinct outputs the calls gave (1 when every call has the first one's
bits), their error against the plain forward, and whether they have the
first variant's bits. The forward mode ends with the whole network's
gradient on 8 frames against its CPU copy (``chip_smoke.grad_check``,
``pallas_qkv``, float32 and bf16), ``grad_checks`` times (default 3) with
each such variant's K2f and with the library the package builds itself
(``ops/_build.py``, tag ``build``), and once with its forward swapped for
the plain version; a failed check is printed and the others still run. Both counts
are set by a third argument, ``'{"repeats": 50, "grad_checks": 5}'``.

In both modes a variant ``{"csrc": DIR}`` builds another checkout's source
as it is. Every variant is compiled by its own ``nvcc`` (all at once, with
the flags of ``ops/_build.py``); ptxas's registers and spills are printed per
kernel; every variant is timed with CUDA events once and then again in
reverse order, and the script says whether its outputs have the first
variant's bits; at the first shape it also prints each variant's device time
by kernel (``torch.profiler``: the weight split, the fused kernel, ...). Run
from the root of a checkout on a machine with a GPU:

    python3 tune_fused_ffn_bwd.py '{"base": {}, "s16": {"slices": 16}}'
    python3 tune_fused_ffn_bwd.py fwd '{"base": {}, "ring1": {"kFStages": 1}}'
    python3 tune_fused_ffn_bwd.py fwd '{"base": {}}' '{"repeats": 50, "grad_checks": 5}'

Builds go to ``_archive/tune_ffn/`` (listed in ``.gitignore``).
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

NAMES = ("dx", "dln_w", "dln_b", "dw1", "db1", "dw2", "db2")
SHAPES = ((256 * 198, "float32"), (256 * 198, "bfloat16"), (512 * 197, "float32"))
FWD_SHAPES = ((256 * 198, "float32"), (64 * 198, "float32"), (128 * 197, "float32"),
              (256 * 198, "bfloat16"), (64 * 198, "bfloat16"))
SEEDS = (0x1234ABCD, 0x0BADF00D)
# the variant's settings that are not constants of the source
OPTIONS = ("csrc", "abi", "slices", "probe", "ieee_gelu")
# rows whose last 64-row block is partial, for the repeated calls
RAGGED_ROWS = (1001, 8 * 198, 4 * 786)
PHASES = ("layernorm", "wait", "fc1_gelu", "sync_gd", "fc2", "sync_stage", "issue", "epilogue")
# (anchor in fused_ffn.cu, the probe put after it): the counters, the first
# time stamp, and the end of each phase
PROBES = (
    ('#include "philox.cuh"\n',
     "__device__ unsigned long long g_probe[8][8];\n"
     "#define PROBE(k) do { long long t_ = clock64(); if (lane == 0) "
     "atomicAdd(&g_probe[warp][k], (unsigned long long)(t_ - probe_t0)); probe_t0 = t_; } "
     "while (0)\n"),
    ("  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n",
     "  long long probe_t0 = clock64();\n"),
    ("  __syncthreads();  // u and the mbarriers are ready\n", "  PROBE(0);\n"),
    ("((i + 1) / kFStages) & 1);\n", "    PROBE(1);\n"),
    ("      }\n    }\n    __syncthreads();  // the chunk's gd is complete\n", None),
    ("    __syncthreads();  // the chunk's gd is complete\n", "    PROBE(3);\n"),
    ("D * kLH, 16 * cg, 64, pairs, kHC, lane);\n", "    PROBE(4);\n"),
    ("    __syncthreads();  // every warp is done with this stage and gd\n", "    PROBE(5);\n"),
    ("issue(i + kFStages);\n", "    PROBE(6);\n"),
    ('extern "C" {\n',
     "int eavit_probe_read(unsigned long long* out, int reset) {\n"
     "  if (reset) { unsigned long long z[8][8] = {}; "
     "return cudaMemcpyToSymbol(g_probe, z, sizeof(z)); }\n"
     "  return cudaMemcpyFromSymbol(out, g_probe, sizeof(g_probe));\n}\n"),
)


def with_probes(text):
    """fused_ffn.cu with the clock64 probes of PROBES in its fused kernel."""
    for anchor, probe in PROBES:
        if anchor not in text:
            raise SystemExit(f"probe: no anchor {anchor!r} in fused_ffn.cu")
        if probe is None:  # the GELU's end: just before the sync after it
            text = text.replace(anchor, anchor.replace(
                "    __syncthreads();  // the chunk's gd", "    PROBE(2);\n"
                "    __syncthreads();  // the chunk's gd"), 1)
        else:
            text = text.replace(anchor, anchor + probe, 1)
    # the epilogue's end: the last line of the fused kernel
    end = text.index("__global__ void fused_ffn_bits_kernel")
    close = text.rindex("}\n", 0, end)
    return text[:close] + "  PROBE(7);\n" + text[close:]


def build(variants, out_dir, source):
    from eavit_tpu_torch.ops import _build

    procs = {}
    for name, subs in variants.items():
        src_dir = subs.get("csrc", str(_build.CSRC))  # another checkout's, as it is
        consts = {k: v for k, v in subs.items() if k not in OPTIONS}
        if consts or subs.get("probe") or subs.get("ieee_gelu"):  # a copy of csrc, edited
            src_dir = os.path.join(out_dir, f"{name}_csrc")
            shutil.copytree(_build.CSRC, src_dir, dirs_exist_ok=True)
            path = os.path.join(src_dir, f"{source}.cu")
            with open(path) as fh:
                text = fh.read()
            for key, value in consts.items():
                text, n = re.subn(rf"constexpr int {key} = \d+;", f"constexpr int {key} = {value};",
                                  text)
                if n != 1:
                    raise SystemExit(f"{name}: no constant {key} in {source}.cu")
            if subs.get("probe"):
                text = with_probes(text)
            if subs.get("ieee_gelu"):
                if "gelu<true>(" not in text:
                    raise SystemExit(f"{name}: no gelu<true> in {source}.cu")
                text = text.replace("gelu<true>(", "gelu<false>(")
            with open(path, "w") as fh:
                fh.write(text)
        path = os.path.join(src_dir, f"{source}.cu")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", src_dir,
               "-o", os.path.join(out_dir, f"{name}.so"), path]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    built = []
    for name, proc in procs.items():
        log = proc.communicate()[0]
        regs, kernel = {}, None
        for line in log.splitlines():
            if m := re.search(r"Compiling entry function '\S*?([a-z][a-z_]*_kernel)I(\w+?)E",
                              line):
                kernel = f"{m.group(1)}<{m.group(2)}>"
            elif kernel and (m := re.search(r"(\d+) bytes spill stores", line)):
                regs.setdefault(kernel, {})["spill_stores"] = int(m.group(1))
            elif kernel and (m := re.search(r"Used (\d+) registers", line)):
                regs.setdefault(kernel, {})["registers"] = int(m.group(1))
        print(json.dumps({"variant": name, "settings": variants[name], "rc": proc.returncode,
                          "ptxas": regs}), flush=True)
        if proc.returncode == 0:
            built.append(name)
        else:
            print(log, file=sys.stderr)
    return built


def parent_call(lib, x, params, dy, seeds, rate):
    """K2b through the C interface of the CUDA-core kernel it replaced: 32-row
    dx tiles and no plane scratch."""
    import torch

    from eavit_tpu_torch.ops import _build
    from eavit_tpu_torch.ops.kernel_prng import dropout_args

    vp, i, f, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint32
    fn = lib.eavit_fused_ffn_bwd
    fn.argtypes = [vp] * 11 + [ctypes.c_longlong, i, i, i, i, f, u, f, u, u, i, vp]
    rows, dim = x.shape
    hidden = params[2].shape[0]
    thresh, inv_keep, (s0, s1) = dropout_args(seeds, rate)
    tiles = (rows + 31) // 32
    slices = min(16, tiles)  # the CUDA-core kernel's choice
    wide = 2 * hidden * dim + hidden
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    grads = torch.empty(wide + 3 * dim, **f32)
    part_dx = torch.empty((tiles, 3 * dim), **f32)
    part_dw = torch.empty((slices, wide), **f32)
    err = fn(*(_build.ptr(t) for t in (x, *params[:5], dy, dx, grads, part_dx, part_dw)),
             rows, dim, hidden, slices, _build.DTYPE_CODES[x.dtype], 1e-5, thresh or 0,
             float(inv_keep), s0, s1, int(thresh is not None), _build.stream_ptr(x))
    _build.check(err, "parent fused_ffn_bwd")
    dw1, dw2, db1, dln_w, dln_b, db2 = grads.split(
        [hidden * dim, dim * hidden, hidden, dim, dim, dim])
    return (dx, dln_w, dln_b, dw1.view(hidden, dim), db1, dw2.view(dim, hidden), db2)


def parent_fwd_call(lib, x, params, seeds, rate):
    """K2f through the C interface of the CUDA-core kernel it replaced (no
    weight-plane scratch)."""
    import torch

    from eavit_tpu_torch.ops import _build
    from eavit_tpu_torch.ops.kernel_prng import dropout_args

    vp, i, f, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint32
    fn = lib.eavit_fused_ffn_fwd
    fn.argtypes = [vp] * 8 + [ctypes.c_longlong, i, i, i, f, u, f, u, u, i, vp]
    rows, dim = x.shape
    thresh, inv_keep, (s0, s1) = dropout_args(seeds, rate)
    y = torch.empty_like(x)
    err = fn(*(_build.ptr(t) for t in (x, *params, y)), rows, dim, params[2].shape[0],
             _build.DTYPE_CODES[x.dtype], 1e-5, thresh or 0, float(inv_keep), s0, s1,
             int(thresh is not None), _build.stream_ptr(x))
    _build.check(err, "parent fused_ffn_fwd")
    return y


def time_ms(fn, iters=5):
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_ms(call, reps=3):
    """Device time by kernel over ``reps`` calls, per call."""
    import torch

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    by_kernel = {e.key[:60]: getattr(e, "device_time_total", 0) / (1e3 * reps)
                 for e in prof.key_averages()}
    return {k: v for k, v in by_kernel.items() if v > 0}


def inputs(torch, dev, rows, dtype):
    d, hid = 256, 1024
    g = torch.Generator().manual_seed(rows)
    f = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    params = tuple(p.to(dev) for p in (
        1.0 + 0.1 * f(d), 0.1 * f(d), f(hid, d) / d ** 0.5, 0.1 * f(hid),
        f(d, hid) / hid ** 0.5, 0.1 * f(d)))
    return f(rows, d).to(dev, dtype), f(rows, d).to(dev, dtype), params


def forward_mode(variants, built, out_dir, dev, run) -> bool:
    import torch

    from eavit_tpu_torch.ops import _build
    from eavit_tpu_torch.ops import fused_ffn as ff

    def call_of(name, x, params):
        lib = ctypes.CDLL(os.path.abspath(os.path.join(out_dir, f"{name}.so")))
        if variants[name].get("abi") == "parent":
            return lambda: parent_fwd_call(lib, x, params, SEEDS, 0.1)

        def call():
            _build._libs["fused_ffn"] = lib
            return ff.fused_ffn_fwd(x, *params, SEEDS, 0.1)
        return call

    probed = [n for n in built if variants[n].get("probe")]
    built = [n for n in built if n not in probed]
    for name in probed:
        lib = ctypes.CDLL(os.path.abspath(os.path.join(out_dir, f"{name}.so")))
        lib.eavit_probe_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
        for rows, dname in FWD_SHAPES[:1] + FWD_SHAPES[3:4]:
            x, _, params = inputs(torch, dev, rows, getattr(torch, dname))
            call = call_of(name, x, params)
            call()
            torch.cuda.synchronize()
            counts = (ctypes.c_ulonglong * 64)()
            lib.eavit_probe_read(counts, 1)
            call()
            torch.cuda.synchronize()
            lib.eavit_probe_read(counts, 0)
            blocks = (rows + 63) // 64
            cycles = [sum(counts[w * 8 + k] for w in range(8)) / (8 * blocks) for k in range(8)]
            total = sum(cycles)
            print(json.dumps({"variant": name, "probe": True, "rows": rows, "dtype": dname,
                              "cycles_per_block": total,
                              "cycles_by_phase": dict(zip(PHASES, cycles)),
                              "share_by_phase": {p: c / total for p, c in zip(PHASES, cycles)}}),
                  flush=True)
    _build._libs.pop("fused_ffn", None)

    for rows, dname in FWD_SHAPES:
        x, _, params = inputs(torch, dev, rows, getattr(torch, dname))
        plain = ff.fused_ffn_fwd_plain(x, *params, SEEDS, 0.1).float()
        scale = plain.abs().max().item()
        tol = 1e-4 * scale if dname == "float32" else 1e-2 + 8e-3 * scale
        calls = {name: call_of(name, x, params) for name in built}
        times = {name: [] for name in built}
        for name in built + built[::-1]:
            times[name].append(time_ms(calls[name], 20))
        first = None
        for name in built:
            y = calls[name]()
            torch.cuda.synchronize()
            err = (y.float() - plain).abs().max().item()
            first = y if first is None else first
            print(json.dumps({"variant": name, "kernel": "fused_ffn_fwd", "rows": rows,
                              "dtype": dname, "ms": times[name], "max_abs_err": err,
                              "tol": tol, "within_tol": err <= tol,
                              f"equal_bits_to_{built[0]}": bool(torch.equal(y, first))}),
                  flush=True)
        if (rows, dname) == FWD_SHAPES[0]:
            for name in built:
                print(json.dumps({"variant": name, "rows": rows, "dtype": dname,
                                  "kernel_ms": kernel_ms(calls[name])}), flush=True)
        del plain, first, x
        torch.cuda.empty_cache()
    _build._libs.pop("fused_ffn", None)

    # repeated calls at row counts that leave a partial last block
    ours = [n for n in built if variants[n].get("abi") != "parent"]
    for rows in RAGGED_ROWS:
        for dname in ("float32", "bfloat16"):
            x, _, params = inputs(torch, dev, rows, getattr(torch, dname))
            for rate in (0.0, 0.1):
                plain = ff.fused_ffn_fwd_plain(x, *params, SEEDS, rate).float()
                scale = plain.abs().max().item()
                tol = 1e-4 * scale if dname == "float32" else 1e-2 + 8e-3 * scale
                first = None
                for name in ours:
                    lib = ctypes.CDLL(os.path.abspath(os.path.join(out_dir, f"{name}.so")))
                    _build._libs["fused_ffn"] = lib
                    outs = [ff.fused_ffn_fwd(x, *params, SEEDS, rate)
                            for _ in range(run["repeats"])]
                    torch.cuda.synchronize()
                    distinct = [outs[0]]
                    for y in outs[1:]:
                        if not any(torch.equal(y, d) for d in distinct):
                            distinct.append(y)
                    err = max((y.float() - plain).abs().max().item() for y in distinct)
                    first = outs[0] if first is None else first
                    print(json.dumps({"variant": name, "kernel": "fused_ffn_fwd", "rows": rows,
                                      "dtype": dname, "rate": rate, "calls": len(outs),
                                      "distinct_outputs": len(distinct), "max_abs_err": err,
                                      "tol": tol, "within_tol": err <= tol,
                                      f"equal_bits_to_{ours[0]}": bool(
                                          torch.equal(outs[0], first))}), flush=True)
                    del outs, distinct
            del x, params
    _build._libs.pop("fused_ffn", None)
    torch.cuda.empty_cache()

    # the whole network's gradient against its CPU copy, with each variant's
    # K2f, the package's own build, and its forward swapped for the plain
    # version
    import chip_smoke

    failed = []

    def grad_checks(tag, times):
        for i in range(times):
            print(json.dumps({"grad_check_with_k2f": tag, "run": i}), flush=True)
            for dname, tol in (("float32", 2e-3), ("bfloat16", 5e-2)):
                try:
                    chip_smoke.grad_check(torch, dev, dname, tol, "pallas_qkv")
                except SystemExit as e:  # print it and go on with the other readings
                    print(json.dumps({"grad_check_failed": tag, "run": i, "why": str(e)}),
                          flush=True)
                    failed.append((tag, i, dname))

    for name in ours:
        lib = ctypes.CDLL(os.path.abspath(os.path.join(out_dir, f"{name}.so")))
        _build._libs["fused_ffn"] = lib
        grad_checks(name, run["grad_checks"])
    _build._libs.pop("fused_ffn", None)
    grad_checks("build", run["grad_checks"])
    kernel = ff.fused_ffn_fwd
    ff.fused_ffn_fwd = ff.fused_ffn_fwd_plain
    grad_checks("plain_forward", 1)
    ff.fused_ffn_fwd = kernel
    return not failed


def main() -> int:
    import torch

    from eavit_tpu_torch.ops import _build
    from eavit_tpu_torch.ops import fused_ffn as ff

    if not torch.cuda.is_available():
        print("tune_fused_ffn_bwd: no CUDA device", file=sys.stderr)
        return 2
    # comparisons in full float32: no TF32 in matmuls or cuDNN convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    args = sys.argv[1:]
    forward = bool(args) and args[0] == "fwd"
    if args and args[0] in ("fwd", "bwd"):
        args = args[1:]
    variants = json.loads(args[0]) if args else {"base": {}}
    run = {"repeats": 20, "grad_checks": 3, **(json.loads(args[1]) if len(args) > 1 else {})}
    out_dir = os.path.join("_archive", "tune_ffn")
    os.makedirs(out_dir, exist_ok=True)
    built = build(variants, out_dir, "fused_ffn" if forward else "fused_ffn_bwd")
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip(),
          flush=True)
    if forward:
        return 0 if forward_mode(variants, built, out_dir, dev, run) else 1
    default_slices = ff._BWD_SLICES

    def call_of(name, x, params, dy):
        lib = ctypes.CDLL(os.path.abspath(os.path.join(out_dir, f"{name}.so")))
        if variants[name].get("abi") == "parent":
            return lambda: parent_call(lib, x, params, dy, SEEDS, 0.1)
        if "csrc" in variants[name]:  # another checkout's: its fused entry alone
            vp, i, f, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint32
            lib.eavit_fused_ffn_bwd.argtypes = [vp] * 14 + [
                ctypes.c_longlong, i, i, i, i, f, u, f, u, u, i, vp]
            lib._eavit_typed = True
        slices = variants[name].get("slices", default_slices)

        def call():
            _build._libs["fused_ffn_bwd"] = lib
            ff._BWD_SLICES = slices
            return ff.fused_ffn_bwd(x, *params[:5], dy, SEEDS, 0.1)
        return call

    for rows, dname in SHAPES:
        x, dy, params = inputs(torch, dev, rows, getattr(torch, dname))
        plain = ff.fused_ffn_bwd_plain(x, *params[:5], dy, SEEDS, 0.1)
        tol = {k: 1e-4 if dname == "float32" else (1.2e-2 if k == "dx" else 2e-3)
               for k in NAMES}
        calls = {name: call_of(name, x, params, dy) for name in built}
        times = {name: [] for name in built}
        for name in built + built[::-1]:
            times[name].append(time_ms(calls[name]))
        first = None
        for name in built:
            out = calls[name]()
            torch.cuda.synchronize()
            rel = {k: ((a.float() - p.float()).abs().max() / p.float().abs().max()).item()
                   for k, a, p in zip(NAMES, out, plain)}
            first = first or out
            same = all(torch.equal(a, b) for a, b in zip(out, first))
            print(json.dumps({"variant": name, "rows": rows, "dtype": dname, "ms": times[name],
                              "max_rel_err": rel,
                              "within_tol": all(rel[k] <= tol[k] for k in NAMES),
                              f"equal_bits_to_{built[0]}": same}), flush=True)
        if rows == SHAPES[0][0] and dname == SHAPES[0][1]:
            for name in built:  # device time by kernel, three calls
                print(json.dumps({"variant": name, "rows": rows, "dtype": dname,
                                  "kernel_ms": kernel_ms(calls[name])}), flush=True)
        del plain, first, x, dy
        torch.cuda.empty_cache()
    ff._BWD_SLICES = default_slices
    _build._libs.pop("fused_ffn_bwd", None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
