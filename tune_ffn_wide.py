#!/usr/bin/env python3
"""Build variants of K2's split path (csrc/ffn_wide.cuh) and time them on one GPU.

The split path runs K2f and K2b at every width the fused kernels do not
take; the HF-flavour ViT (dim 1,024, hidden 3,072) runs it. A variant is the
checkout's ``eavit_tpu_torch/csrc`` with integer or boolean constants of
``ffn_wide.cuh`` replaced (``{"kOutCols": 256, "kOutMinBlocks": 1}``: the
tile columns and blocks an SM of each product, ``kFastErf``), or (``{"csrc":
DIR}``) another checkout's sources as they are; ``"abi": "parent"`` calls such
a build through the C interface of the split path before its wgmma redesign
(float32 H, G and Y scratch, dW by row slices).

Every variant's ``fused_ffn.cu`` and ``fused_ffn_bwd.cu`` is compiled by its
own ``nvcc`` (all at once, with the flags of ``ops/_build.py``) into
``_archive/tune_wide/`` (listed in ``.gitignore``), and ptxas's registers and
spills are printed per product kernel. Each variant is held to the plain
forward and backward at 300 rows of (1,024, 3,072), float32 and bf16, rate
0.1 (the tolerances of tests/test_torch_port_cuda.py), then timed with CUDA
events at the HF flavour's minibatch (13,056 rows) and act (3,264 rows) in
bf16 and at 13,056 rows in float32, rate 0, in turns (the variants in order,
then in reverse), and the device time by kernel of one forward and backward
at 13,056 rows in bf16 is printed (``torch.profiler``). Run from the root of
a checkout on a machine with a GPU:

    python3 tune_ffn_wide.py '{"base": {}, "out256": {"kOutCols": 256, "kOutMinBlocks": 1}}'
    python3 tune_ffn_wide.py '{"parent": {"csrc": "_archive/parent/eavit_tpu_torch/csrc",
                                          "abi": "parent"}, "base": {}}'
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "_archive", "tune_wide")
HG = (1024, 3072, 1e-12)  # dim, hidden, LayerNorm eps of ViTHGConfig
NAMES = ("dx", "dln_w", "dln_b", "dw1", "db1", "dw2", "db2")


def build(variants, nvcc_flags, nvcc, csrc):
    shutil.rmtree(OUT, ignore_errors=True)
    procs = []
    for name, spec in variants.items():
        d = os.path.join(OUT, name)
        shutil.copytree(os.path.join(ROOT, spec.get("csrc", csrc)), d)
        consts = {k: v for k, v in spec.items() if k not in ("csrc", "abi")}
        if consts:
            path = os.path.join(d, "ffn_wide.cuh")
            src = open(path).read()
            for k, v in consts.items():
                v = str(v).lower() if isinstance(v, bool) else str(v)
                src, n = re.subn(rf"\b{k} = \w+", f"{k} = {v}", src)
                if n != 1:
                    raise SystemExit(f"{name}: constant {k} found {n} times")
            open(path, "w").write(src)
        for stem in ("fused_ffn", "fused_ffn_bwd"):
            cmd = [nvcc, *nvcc_flags, "-I", d, "-o", os.path.join(d, f"lib{stem}.so"),
                   os.path.join(d, f"{stem}.cu")]
            procs.append((name, stem, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs = {}
    for name, stem, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name} {stem}:\n{out[-4000:]}")
        logs[name] = logs.get(name, "") + f"== {stem}.cu\n{out}"
    return logs


def parent_calls(torch, ff, _build, libs):
    """K2f and K2b of the split path through the C interface it had before
    the wgmma redesign: float32 fbuf for H (then Y) and G, dW by row slices."""
    vp, i, f, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint32
    fwd, bwd = libs["fused_ffn"].eavit_fused_ffn_fwd_wide, libs["fused_ffn_bwd"].eavit_fused_ffn_bwd_wide
    fwd.argtypes = [vp] * 12 + [ctypes.c_longlong, i, i, i, f, u, f, u, u, i, vp]
    bwd.argtypes = [vp] * 16 + [ctypes.c_longlong, i, i, i, i, f, u, f, u, u, i, vp]
    fwd.restype = bwd.restype = i

    def common(x2, hidden, seeds, rate):
        rows, dim = x2.shape
        thresh, inv_keep, (s0, s1) = ff.dropout_args(seeds, rate)
        dp, hp = ff._pad32(dim), ff._pad32(hidden)
        planes = 2 if x2.dtype == torch.float32 else 1
        return rows, dim, dp, hp, planes, (thresh or 0, float(inv_keep), s0, s1,
                                            int(thresh is not None))

    def fwd_call(x2, ln_w, ln_b, w1, b1, w2, b2, seeds=None, rate=0.0, eps=1e-5):
        hidden = w1.shape[0]
        rows, dim, dp, hp, planes, drop = common(x2, hidden, seeds, rate)
        bf = dict(dtype=torch.bfloat16, device=x2.device)
        y = torch.empty_like(x2)
        scratch = (torch.empty((2, planes, hp * dp), **bf), torch.empty((planes, rows, dp), **bf),
                   torch.empty((rows, max(hp, dp)), dtype=torch.float32, device=x2.device),
                   torch.empty((planes, rows, hp), **bf))
        ptrs = [_build.ptr(t) for t in (x2, ln_w, ln_b, w1, b1, w2, b2, y, *scratch)]
        _build.check(fwd(*ptrs, rows, dim, hidden, _build.DTYPE_CODES[x2.dtype], float(eps),
                         *drop, _build.stream_ptr(x2)), "parent fused_ffn_fwd")
        return y

    def bwd_call(x2, ln_w, ln_b, w1, b1, w2, dy, seeds=None, rate=0.0, eps=1e-5):
        hidden = w1.shape[0]
        rows, dim, dp, hp, planes, drop = common(x2, hidden, seeds, rate)
        tiles, slices = (rows + 63) // 64, min(33, (rows + 31) // 32)
        f32 = dict(dtype=torch.float32, device=x2.device)
        bf = dict(dtype=torch.bfloat16, device=x2.device)
        dx = torch.empty_like(x2)
        grads = torch.empty(2 * hp * dp + hp + 3 * dp, **f32)
        scratch = (grads, torch.empty((tiles, hp + 3 * dp), **f32),
                   torch.empty((slices, 2 * hp * dp), **f32),
                   torch.empty((2, planes, hp * dp), **bf),
                   torch.empty((2, planes, rows, dp), **bf),
                   torch.empty((2, planes, rows, hp), **bf),
                   torch.empty((2, rows, max(hp, dp)), **f32), torch.empty((2, rows), **f32))
        ptrs = [_build.ptr(t) for t in (x2, ln_w, ln_b, w1, b1, w2, dy, dx, *scratch)]
        _build.check(bwd(*ptrs, rows, dim, hidden, slices, _build.DTYPE_CODES[x2.dtype],
                         float(eps), *drop, _build.stream_ptr(x2)), "parent fused_ffn_bwd")
        dw1, dw2, db1, dln_w, dln_b, db2 = grads.split([hp * dp, dp * hp, hp, dp, dp, dp])
        return (dx, dln_w[:dim], dln_b[:dim], dw1.view(hp, dp)[:hidden, :dim],
                db1[:hidden], dw2.view(dp, hp)[:dim, :hidden], db2[:dim])

    return fwd_call, bwd_call


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from eavit_tpu_torch.ops import _build
    from eavit_tpu_torch.ops import fused_ffn as ff

    if not torch.cuda.is_available():
        print("tune_ffn_wide: no CUDA device", file=sys.stderr)
        return 2
    variants = json.loads(sys.argv[1]) if len(sys.argv) > 1 else {"base": {}}
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.gpu_name_power(), flush=True)
    logs = build(variants, _build.NVCC_FLAGS, _build._nvcc(),
                 os.path.relpath(_build.CSRC, ROOT))
    for name, log in logs.items():
        report = cs.ptxas_report(log)
        for src in ("fused_ffn.cu", "fused_ffn_bwd.cu"):
            for row, info in sorted(cs.mma_ptxas(report, src, "ffn").items()):
                if row.startswith(("wg_gemm", "wide_", "split_planes_t")):
                    print(json.dumps({"variant": name, "kernel": row, **info}), flush=True)
    calls = {}
    for name, spec in variants.items():
        libs = {stem: ctypes.CDLL(os.path.join(OUT, name, f"lib{stem}.so"))
                for stem in ("fused_ffn", "fused_ffn_bwd")}
        if spec.get("abi") == "parent":
            calls[name] = parent_calls(torch, ff, _build, libs)
        else:
            def fwd(*a, _libs=libs, **kw):
                _build._libs.update(_libs)
                return ff.fused_ffn_fwd(*a, **kw)

            def bwd(*a, _libs=libs, **kw):
                _build._libs.update(_libs)
                return ff.fused_ffn_bwd(*a, **kw)
            calls[name] = (fwd, bwd)
    dev = torch.device("cuda")
    d, hid, eps = HG
    params, f = cs._ffn_params(torch, dev, d, hid, 300)
    x32, dy32 = f(300, d).to(dev), f(300, d).to(dev)
    for name, (fwd, bwd) in calls.items():
        for dtype in (torch.float32, torch.bfloat16):
            x, dy = x32.to(dtype), dy32.to(dtype)
            seeds, rate = cs.KERNEL_SEEDS, 0.1
            got = (fwd(x, *params, seeds, rate, eps), *bwd(x, *params[:5], dy, seeds, rate, eps))
            want = (ff.fused_ffn_fwd_plain(x, *params, seeds, rate, eps),
                    *ff.fused_ffn_bwd_plain(x, *params[:5], dy, seeds, rate, eps))
            rel = {k: ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()
                   for k, a, b in zip(("y",) + NAMES, got, want)}
            tol = ({k: 1e-4 for k in rel} if dtype == torch.float32 else
                   {k: 8e-3 if k == "y" else 1.2e-2 if k == "dx" else 2e-3 for k in rel})
            again = (fwd(x, *params, seeds, rate, eps), *bwd(x, *params[:5], dy, seeds, rate, eps))
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            ok = same and all(rel[k] <= tol[k] for k in rel)
            print(json.dumps({"variant": name, "check": str(dtype)[6:], "ok": ok, "same": same,
                              "rel": rel}), flush=True)
    shapes = [(13056, torch.bfloat16), (3264, torch.bfloat16), (13056, torch.float32)]
    inputs = {}
    for rows, dtype in shapes:
        params, f = cs._ffn_params(torch, dev, d, hid, rows)
        inputs[(rows, dtype)] = (f(rows, d).to(dev, dtype), f(rows, d).to(dev, dtype), params)
    for order in (list(calls), list(calls)[::-1]):
        for name in order:
            fwd, bwd = calls[name]
            for (rows, dtype), (x, dy, params) in inputs.items():
                print(json.dumps({
                    "variant": name, "rows": rows, "dtype": str(dtype)[6:],
                    "fwd_ms": cs.time_ms(torch, lambda: fwd(x, *params, None, 0.0, eps), 20),
                    "bwd_ms": cs.time_ms(torch, lambda: bwd(x, *params[:5], dy, None, 0.0, eps),
                                         10)}), flush=True)
    x, dy, params = inputs[(13056, torch.bfloat16)]
    for name, (fwd, bwd) in calls.items():
        fwd(x, *params, None, 0.0, eps)
        bwd(x, *params[:5], dy, None, 0.0, eps)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                fwd(x, *params, None, 0.0, eps)
                bwd(x, *params[:5], dy, None, 0.0, eps)
            torch.cuda.synchronize()
        by = {}
        for e in prof.key_averages():
            if e.device_time_total > 0:
                key = re.sub(r"\(anonymous namespace\)::|void |__nv_bfloat16", "", e.key)
                key = re.sub(r"\(.*", "", key).replace("  ", " ")
                by[key] = by.get(key, 0.0) + e.device_time_total / 5e3
        print(json.dumps({"variant": name, "rows": 13056, "dtype": "bfloat16",
                          "device_ms_by_kernel": by}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    sys.exit(main())
