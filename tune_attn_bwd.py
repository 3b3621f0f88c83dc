#!/usr/bin/env python3
"""Build variants of the tensor-core attention backward and time them on one GPU.

Each variant is ``eavit_tpu_torch/csrc/attn_bwd_mma.cuh`` with some of its
constants replaced (``kMmaWarps``, ``kMinBlocks``), compiled into the bf16
K1b (``flash_qkv_bwd.cu``) and K3b (``flash_dropout.cu``) with the flags of
``ops/_build.py``, all variants at once. Per variant it prints the registers
and spills ptxas reports for the ``Dh`` = 32 kernels, holds K1b and K3b to
their plain versions on a few heads, and times them with CUDA events at the
flagship minibatch ``[256, 8, 198, 32]`` (K1b at rate 0 and 0.1, K3b at
0.1) and the stacked one ``[512, 8, 197, 32]``, in turns (every variant
once, then again in reverse order). Run from the root of a checkout on a
machine with a GPU:

    python3 tune_attn_bwd.py '{"base": {}, "w4": {"kMmaWarps": 4}}'

Builds go to ``_archive/tune_bwd/`` (listed in ``.gitignore``).
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

SOURCES = ("flash_qkv_bwd", "flash_dropout")
SHAPES = [(256, 198, 2), (512, 197, 0)]  # (B, N, num_special) at H = 8, Dh = 32


def build(variants, out_dir):
    from eavit_tpu_torch.ops import _build

    header = (_build.CSRC / "attn_bwd_mma.cuh").read_text()
    procs = {}
    for name, subs in variants.items():
        vdir = os.path.join(out_dir, name)
        os.makedirs(vdir, exist_ok=True)
        for f in _build.CSRC.iterdir():
            if f.suffix in (".cu", ".cuh"):
                shutil.copy(f, vdir)
        text = header
        for key, value in subs.items():
            text, n = re.subn(rf"constexpr int {key} = \d+;", f"constexpr int {key} = {value};",
                              text)
            if n != 1:
                raise SystemExit(f"{name}: no constant {key}")
        with open(os.path.join(vdir, "attn_bwd_mma.cuh"), "w") as fh:
            fh.write(text)
        for src in SOURCES:
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", vdir,
                   "-o", os.path.join(vdir, f"lib{src}.so"), os.path.join(vdir, f"{src}.cu")]
            procs[(name, src)] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                  stderr=subprocess.STDOUT, text=True)
    failed = set()
    for (name, src), proc in procs.items():
        log = proc.communicate()[0]
        regs, kernel = {}, None
        for line in log.splitlines():
            m = re.search(r"attn_bwd_mma_kernelILi(\d+)ELb([01])ELb([01])E", line)
            if m:
                kernel = f"Dh{m.group(1)}{' dropout' if m.group(3) == '1' else ''}"
            elif kernel and (m := re.search(r"(\d+) bytes spill stores", line)):
                regs.setdefault(kernel, {})["spill_stores"] = int(m.group(1))
            elif kernel and (m := re.search(r"Used (\d+) registers", line)):
                regs.setdefault(kernel, {})["registers"] = int(m.group(1))
                kernel = None
        print(json.dumps({"variant": name, "source": src, "constants": variants[name],
                          "rc": proc.returncode,
                          "ptxas": {k: v for k, v in regs.items() if k.startswith("Dh32")}}),
              flush=True)
        if proc.returncode:
            failed.add(name)
            print(log, file=sys.stderr)
    return [n for n in variants if n not in failed]


def main() -> int:
    import torch

    from eavit_tpu_torch.ops import _build
    from eavit_tpu_torch.ops import flash_dropout as fd
    from eavit_tpu_torch.ops import flash_qkv as fq

    if not torch.cuda.is_available():
        print("tune_attn_bwd: no CUDA device", file=sys.stderr)
        return 2
    variants = json.loads(sys.argv[1]) if len(sys.argv) > 1 else {"base": {}}
    out_dir = os.path.join("_archive", "tune_bwd")
    os.makedirs(out_dir, exist_ok=True)
    built = build(variants, out_dir)
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip(),
          flush=True)

    def use(name):
        for src in SOURCES:
            lib = ctypes.CDLL(os.path.abspath(os.path.join(out_dir, name, f"lib{src}.so")))
            _build._libs[src] = lib
        fq._bwd_lib()  # argument types on the fresh library
        fd._lib()

    def time_ms(fn, iters=20):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    h, dh, seeds = 8, 32, (0x1234ABCD, 0x0BADF00D)
    scale = dh ** -0.5
    for b, n, ns in SHAPES:
        g = torch.Generator().manual_seed(n)
        q, k, v, do = (torch.randn(b, h, n, dh, generator=g).to(dev, torch.bfloat16)
                       for _ in range(4))
        qkv = torch.cat([t.transpose(1, 2).reshape(b, n, h * dh) for t in (q, k, v)], -1)
        gm = do.transpose(1, 2).reshape(b, n, h * dh).contiguous()
        _, lse3 = fd.flash_dropout_fwd(q, k, v, seeds, 0.1, scale, ns)
        lse1 = {r: fq.flash_qkv_fwd(qkv, h, dh, scale, ns, seeds, r)[1] for r in (0.0, 0.1)}
        calls = {
            "k1b_rate0": lambda: fq.flash_qkv_bwd(qkv, lse1[0.0], gm, h, dh, scale, ns, seeds, 0.0),
            "k1b_rate0.1": lambda: fq.flash_qkv_bwd(qkv, lse1[0.1], gm, h, dh, scale, ns, seeds,
                                                    0.1),
            "k3b_rate0.1": lambda: fd.flash_dropout_bwd(q, k, v, lse3, do, seeds, 0.1, scale, ns),
        }
        few = slice(0, 4)  # the plain versions on four batch rows
        plain = {
            "k1b_rate0": fq.flash_qkv_bwd_plain(qkv[few], lse1[0.0][few], gm[few], h, dh, scale,
                                                ns, seeds, 0.0),
            "k1b_rate0.1": fq.flash_qkv_bwd_plain(qkv[few], lse1[0.1][few], gm[few], h, dh,
                                                  scale, ns, seeds, 0.1),
            "k3b_rate0.1": fd.flash_dropout_bwd_plain(q[few], k[few], v[few], lse3[few], do[few],
                                                      seeds, 0.1, scale, ns)[0],
        }
        times = {name: {} for name in built}
        for name in built + built[::-1]:
            use(name)
            for kernel, call in calls.items():
                times[name].setdefault(kernel, []).append(time_ms(call))
        for name in built:
            use(name)
            out = {k: c() for k, c in calls.items()}
            out["k3b_rate0.1"] = out["k3b_rate0.1"][0]
            errs = {k: (out[k][few].float() - plain[k].float()).abs().max().item()
                    for k in calls}
            print(json.dumps({"variant": name, "shape": [b, h, n, dh], "num_special": ns,
                              "ms": times[name], "max_abs_err": errs}), flush=True)
    for src in SOURCES:
        _build._libs.pop(src, None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
