#!/usr/bin/env python3
"""Build variants of the KV-streaming kernels and time them on one GPU.

Each variant is ``eavit_tpu_torch/csrc/flash_stream.cu`` with some of the
tile constants of its template ``flash_stream.cuh`` replaced (``kDims``,
``kFwdChunk``, ``kBwdChunk``, ``kRows``, ``kTile``), which the float32 K5f,
K5q and K5kv run (the bf16 K5 runs the tensor-core ``attn_fwd_mma.cuh`` and
``attn_bwd_mma.cuh``, whose constants ``tune_attn_bwd.py`` varies: here they
are timed as the build has them); every variant is
compiled by its own ``nvcc`` (all at once, with
the flags of ``ops/_build.py``), its registers and stack per kernel are read
from ptxas, and K5f, K5q and K5kv are held to the plain versions on a few
heads and timed with CUDA events at the flagship minibatch and at long
sequences, in bf16 and float32, every variant once and then again in
reverse order, and says whether K5f's o on those heads has the first
variant's bits. A variant
``{"csrc": DIR}`` builds ``DIR/flash_stream.cu`` as it is instead (another
checkout's K5, whose C interface is the same), to compare two commits in
one call. Run from the root of a checkout on a machine with a GPU:

    python3 tune_flash_stream.py '{"base": {}, "chunk8": {"kBwdChunk": 8}}'

Builds go to ``_archive/tune/`` (listed in ``.gitignore``).
"""

from __future__ import annotations

import ctypes
import itertools
import json
import os
import re
import subprocess
import sys

SHAPES = [(256, 8, 198, 32, 2), (64, 8, 198, 16, 2), (64, 8, 785, 64, 0),
          (16, 8, 3137, 64, 0)]  # (B, H, N, Dh, num_special)


def build(variants, out_dir):
    from eavit_tpu_torch.ops import _build

    src = (_build.CSRC / "flash_stream.cuh").read_text()
    procs = {}
    for name, subs in variants.items():
        if "csrc" in subs:  # another checkout's sources, as they are
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", subs["csrc"],
                   "-o", os.path.join(out_dir, f"{name}.so"),
                   os.path.join(subs["csrc"], "flash_stream.cu")]
            procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True)
            continue
        text = src
        for key, value in subs.items():
            text, n = re.subn(rf"constexpr int {key} = \d+;", f"constexpr int {key} = {value};",
                              text)
            if n != 1:
                raise SystemExit(f"{name}: no constant {key}")
        vdir = os.path.join(out_dir, name)  # the variant's template beside its source
        os.makedirs(vdir, exist_ok=True)
        with open(os.path.join(vdir, "flash_stream.cuh"), "w") as fh:
            fh.write(text)
        path = os.path.join(vdir, "flash_stream.cu")
        with open(path, "w") as fh:
            fh.write((_build.CSRC / "flash_stream.cu").read_text())
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
               "-o", os.path.join(out_dir, f"{name}.so"), path]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    built = []
    for name, proc in procs.items():
        log = proc.communicate()[0]
        regs, kernel = {}, None
        for line in log.splitlines():
            m = re.search(r"stream_(fwd|dq|dkv)_kernelI(f|13__nv_bfloat16)?Li(\d+)", line)
            if m:
                bf16 = "/bf16" if m.group(2) == "13__nv_bfloat16" else ""
                kernel = f"{m.group(1)}/Dh{m.group(3)}{bf16}"
            elif kernel and "Used" in line:
                r = re.search(r"Used (\d+) registers", line)
                st = re.search(r"(\d+) bytes cumulative stack", line)
                regs[kernel] = (int(r.group(1)), int(st.group(1)) if st else 0)
                kernel = None
        print(json.dumps({"variant": name, "constants": variants[name], "rc": proc.returncode,
                          "registers_stack": regs}), flush=True)
        if proc.returncode == 0:
            built.append(name)
        else:
            print(log, file=sys.stderr)
    return built


def main() -> int:
    import torch

    from eavit_tpu_torch.ops import _build
    from eavit_tpu_torch.ops import flash_stream as fs

    if not torch.cuda.is_available():
        print("tune_flash_stream: no CUDA device", file=sys.stderr)
        return 2
    variants = json.loads(sys.argv[1]) if len(sys.argv) > 1 else {"base": {}}
    out_dir = os.path.join("_archive", "tune")
    os.makedirs(out_dir, exist_ok=True)
    built = build(variants, out_dir)
    dev = torch.device("cuda")

    def time_ms(fn, iters):
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    for (b, h, n, dh, ns), dtype in itertools.product(SHAPES, (torch.bfloat16, torch.float32)):
        g = torch.Generator().manual_seed(n)
        q, k, v, do = (torch.randn(b, h, n, dh, generator=g).to(dev, dtype)
                       for _ in range(4))
        sc, few = dh ** -0.5, (slice(0, min(b, 4)),)
        ref_o, ref_lse = fs.flash_stream_fwd_plain(q[few], k[few], v[few], sc, ns)
        ref_delta = fs.stream_delta(ref_o, do[few])
        ref = fs.flash_stream_bwd_plain(q[few], k[few], v[few], ref_lse, ref_delta, do[few],
                                        sc, ns)
        first_o = None
        for name in built + built[::-1]:
            _build._libs["flash_stream"] = ctypes.CDLL(os.path.abspath(
                os.path.join(out_dir, f"{name}.so")))
            sub = [t[few].contiguous() for t in (q, k, v, do)]
            o, _ = fs.flash_stream_fwd(*sub[:3], sc, ns)
            grads = fs.flash_stream_bwd(*sub[:3], ref_lse, ref_delta, sub[3], sc, ns)
            errs = [(a.float() - r.float()).abs().max().item()
                    for a, r in zip((o, *grads), (ref_o, *ref))]
            first_o = o if first_o is None else first_o
            same = bool(torch.equal(o, first_o))
            o, lse = fs.flash_stream_fwd(q, k, v, sc, ns)
            args = (q, k, v, lse, fs.stream_delta(o, do), do, sc, ns)
            iters = 20 if n < 500 else 3
            print(json.dumps({"variant": name, "shape": [b, h, n, dh], "num_special": ns,
                              "dtype": str(dtype).split(".")[-1],
                              "fwd_ms": time_ms(lambda: fs.flash_stream_fwd(q, k, v, sc, ns),
                                                iters),
                              "dq_ms": time_ms(lambda: fs.flash_stream_dq(*args), iters),
                              "dkv_ms": time_ms(lambda: fs.flash_stream_dkv(*args), iters),
                              "max_abs_err_o_dq_dk_dv": errs,
                              f"o_equal_bits_to_{built[0]}": same}), flush=True)
    _build._libs.pop("flash_stream", None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
