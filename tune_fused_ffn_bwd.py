#!/usr/bin/env python3
"""Build variants of K2b, the fused-FFN backward, and time them on one GPU.

A variant is ``eavit_tpu_torch/csrc/fused_ffn_bwd.cu`` with a number of row
slices of its weight-gradient kernel (``"slices"``; the wrapper's default,
33, if it names none). A variant ``{"csrc": DIR}`` builds another checkout's
``fused_ffn_bwd.cu`` as it is; with ``"abi": "parent"`` it is called through
the C interface of the CUDA-core K2b (no bf16 plane scratch, 32-row dx
tiles), to compare that kernel with this one in one call. Every variant is
compiled by its own ``nvcc`` (all at once, with the flags of
``ops/_build.py``); ptxas's registers and spills are printed per kernel;
each variant is held to the plain backward (1e-4 of each output's maximum in
float32; in bf16 1.2e-2 for dx and 2e-3 for the rest) and timed with CUDA
events at the flagship minibatch (50,688 rows of D = 256, Hd = 1024) in
float32 and bf16 and at the stacked one (101,376 rows, float32), rate 0.1,
every variant once and then again in reverse order, and says whether its
outputs have the first variant's bits; at the first shape it also prints
each variant's device time by kernel (``torch.profiler``). Run from the root
of a checkout on a machine with a GPU:

    python3 tune_fused_ffn_bwd.py '{"base": {}, "s16": {"slices": 16}}'

Builds go to ``_archive/tune_ffn/`` (listed in ``.gitignore``).
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys

NAMES = ("dx", "dln_w", "dln_b", "dw1", "db1", "dw2", "db2")
SHAPES = ((256 * 198, "float32"), (256 * 198, "bfloat16"), (512 * 197, "float32"))
SEEDS = (0x1234ABCD, 0x0BADF00D)


def build(variants, out_dir):
    from eavit_tpu_torch.ops import _build

    procs = {}
    for name, subs in variants.items():
        src_dir = subs.get("csrc", str(_build.CSRC))  # another checkout's, as it is
        path = os.path.join(src_dir, "fused_ffn_bwd.cu")
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


def main() -> int:
    import torch

    from eavit_tpu_torch.ops import _build
    from eavit_tpu_torch.ops import fused_ffn as ff

    if not torch.cuda.is_available():
        print("tune_fused_ffn_bwd: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    variants = json.loads(sys.argv[1]) if len(sys.argv) > 1 else {"base": {}}
    out_dir = os.path.join("_archive", "tune_ffn")
    os.makedirs(out_dir, exist_ok=True)
    built = build(variants, out_dir)
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip(),
          flush=True)
    default_slices = ff._BWD_SLICES

    def call_of(name, x, params, dy):
        lib = ctypes.CDLL(os.path.abspath(os.path.join(out_dir, f"{name}.so")))
        if variants[name].get("abi") == "parent":
            return lambda: parent_call(lib, x, params, dy, SEEDS, 0.1)
        slices = variants[name].get("slices", default_slices)

        def call():
            _build._libs["fused_ffn_bwd"] = lib
            ff._BWD_SLICES = slices
            return ff.fused_ffn_bwd(x, *params[:5], dy, SEEDS, 0.1)
        return call

    def time_ms(fn, iters=5):
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    d, hid = 256, 1024
    for rows, dname in SHAPES:
        dtype = getattr(torch, dname)
        g = torch.Generator().manual_seed(rows)
        f = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
        params = tuple(p.to(dev) for p in (
            1.0 + 0.1 * f(d), 0.1 * f(d), f(hid, d) / d ** 0.5, 0.1 * f(hid),
            f(d, hid) / hid ** 0.5, 0.1 * f(d)))
        x, dy = f(rows, d).to(dev, dtype), f(rows, d).to(dev, dtype)
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
                with torch.profiler.profile(
                        activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                    for _ in range(3):
                        calls[name]()
                    torch.cuda.synchronize()
                by_kernel = {e.key[:60]: getattr(e, "device_time_total", 0) / 3e3
                             for e in prof.key_averages()}
                print(json.dumps({"variant": name, "rows": rows, "dtype": dname,
                                  "kernel_ms": {k: v for k, v in by_kernel.items() if v > 0}}),
                      flush=True)
        del plain, first, x, dy
        torch.cuda.empty_cache()
    ff._BWD_SLICES = default_slices
    _build._libs.pop("fused_ffn_bwd", None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
