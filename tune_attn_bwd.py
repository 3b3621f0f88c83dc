#!/usr/bin/env python3
"""Build variants of the tensor-core attention kernels and time them on one GPU.

Each variant is ``eavit_tpu_torch/csrc/`` with some constants of the
tensor-core templates replaced: the streaming templates' ``kFwdWarps``,
``kFwdKeys`` and ``kFwdMinBlocks`` (``attn_fwd_mma.cuh``: the bf16 K3f,
K4f, the streaming K1f, and K5f in its one-sweep mode) and ``kBwdWarps``, ``kBwdKeys`` and ``kBwdMinBlocks``
(``attn_bwd_mma.cuh``: the streaming K1b, K3b and K4b, and the bf16 K5q and
K5kv), and the whole-head
kernels' ``kHeadFwdWarps`` / ``kHeadFwdMinBlocks`` (``attn_fwd_head.cuh``,
K1f) and ``kHeadWarps`` / ``kHeadMinBlocks`` (``attn_bwd_head.cuh``, K1b, K3b
and K4b). Every variant is compiled into ``flash_qkv.cu``,
``flash_qkv_bwd.cu``, ``flash_dropout.cu``, ``flash.cu`` and
``flash_stream.cu`` with the flags of
``ops/_build.py``, all at once. Per variant it prints the registers and
spills ptxas reports for the ``Dh`` = 32 kernels, holds each kernel to its
plain version on a few heads, and times them with CUDA events at the
flagship minibatch ``[256, 8, 198, 32]``, the stacked one ``[512, 8, 197,
32]``, the act shape ``[64, 8, 198, 32]`` (forwards), the patch-4 and
patch-3 sequences ``[64, 8, 443, 32]`` and ``[16, 8, 786, 32]`` (the
whole-head kernels where a head fits), in turns (every variant once, then
again in reverse order), and says for each kernel whether its output has
the first variant's bits. A variant ``{"csrc": DIR}`` builds another
checkout's sources as they are (their C interface must be this one's), to
compare two commits in one call. Run from the root of a checkout on a
machine with a GPU:

    python3 tune_attn_bwd.py '{"base": {}, "k128": {"kFwdKeys": 128}}'

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

SOURCES = ("flash_qkv", "flash_qkv_bwd", "flash_dropout", "flash", "flash_stream")
HEADERS = ("attn_bwd_mma.cuh", "attn_fwd_mma.cuh", "attn_bwd_head.cuh", "attn_fwd_head.cuh")
# (B, N, num_special, which kernels) at H = 8, Dh = 32: "all" or "fwd" (the
# forwards); the whole-head kernels only where a head fits
SHAPES = [(256, 198, 2, "all"), (512, 197, 0, "all"), (64, 198, 2, "fwd"),
          (64, 443, 2, "all"), (16, 786, 2, "all")]
# a kernel name of ptxas -> the variant label of its report
KERNEL_RE = (
    (r"attn_fwd_mma_kernelILi(\d+)ELb([01])ELb([01])ELb1E", "fwd one sweep"),
    (r"attn_fwd_mma_kernelILi(\d+)ELb([01])ELb([01])E", "fwd"),
    (r"attn_dq_mma_kernelILi(\d+)ELb([01])ELb([01])ELi([012])E", "dq"),
    (r"attn_dkv_mma_kernelILi(\d+)ELb([01])ELb([01])E", "dkv"),
    (r"attn_fwd_head_kernelILi(\d+)()ELb([01])E", "fwd head"),
    (r"attn_bwd_head_kernelILi(\d+)ELb([01])ELb([01])ELb[01]E", "bwd head"),
)
# the dq kernel's row term (common.cuh RowTerm): given (K5q), delta from O (K4b), rowsum
ROW_TERM = {"0": " given", "1": " delta", "2": ""}


def build(variants, out_dir):
    from eavit_tpu_torch.ops import _build

    procs = {}
    for name, subs in variants.items():
        vdir = os.path.join(out_dir, name)
        os.makedirs(vdir, exist_ok=True)
        src_dir = subs.get("csrc", _build.CSRC)
        for f in os.scandir(src_dir):
            if f.name.endswith((".cu", ".cuh")):
                shutil.copy(f.path, vdir)
        subs = {} if "csrc" in subs else subs
        texts = {h: (_build.CSRC / h).read_text() for h in HEADERS if subs}
        for key, value in subs.items():
            found = 0
            for h in HEADERS:
                texts[h], n = re.subn(rf"constexpr int {key} = \d+;",
                                      f"constexpr int {key} = {value};", texts[h])
                found += n
            if found != 1:
                raise SystemExit(f"{name}: no constant {key}")
        for h, text in texts.items():
            with open(os.path.join(vdir, h), "w") as fh:
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
            for pattern, kind in KERNEL_RE:
                if m := re.search(pattern, line):
                    kernel = (f"Dh{m.group(1)} {kind}" + (" rounded" if m.group(2) == "1" else "")
                              + (" dropout" if m.group(3) == "1" else "")
                              + (ROW_TERM[m.group(4)] if kind == "dq" else ""))
                    break
            else:
                if kernel and (m := re.search(r"(\d+) bytes spill stores", line)):
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
    from eavit_tpu_torch.ops import flash as fl
    from eavit_tpu_torch.ops import flash_dropout as fd
    from eavit_tpu_torch.ops import flash_qkv as fq
    from eavit_tpu_torch.ops import flash_stream as fs

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
        fq._lib()  # argument types on the fresh libraries
        fq._bwd_lib()
        fd._lib()
        fl._lib()
        fs._lib()

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
    for b, n, ns, which in SHAPES:
        g = torch.Generator().manual_seed(n)
        few = slice(0, 4)  # the plain versions on four batch rows
        q, k, v, do = (torch.randn(b, h, n, dh, generator=g).to(dev, torch.bfloat16)
                       for _ in range(4))
        qkv = torch.cat([t.transpose(1, 2).reshape(b, n, h * dh) for t in (q, k, v)], -1)
        gm = do.transpose(1, 2).reshape(b, n, h * dh).contiguous()
        _, lse3 = fd.flash_dropout_fwd(q, k, v, seeds, 0.1, scale, ns)
        o4, lse4 = fl.flash_fwd(q, k, v, scale, ns)
        o5, lse5 = fs.flash_stream_fwd(q, k, v, scale, ns)
        k5 = (q, k, v, lse5, fs.stream_delta(o5, do), do, scale, ns)
        k5_few = tuple(t[few] for t in k5[:6]) + (scale, ns)
        lse1 = {r: fq.flash_qkv_fwd(qkv, h, dh, scale, ns, seeds, r)[1] for r in (0.0, 0.1)}
        fits = {"k1f": fq.head_fits("fwd", n, dh, torch.bfloat16),
                "k1b": fq.head_fits("bwd", n, dh, torch.bfloat16),
                "k3b": fd.head_fits(n, dh, torch.bfloat16),
                "k4b": fl.head_fits(n, dh, torch.bfloat16)}
        calls = {  # kernel -> (call, plain call on the first rows, output compared)
            "k3f": (lambda: fd.flash_dropout_fwd(q, k, v, seeds, 0.1, scale, ns)[0],
                    lambda: fd.flash_dropout_fwd_plain(q[few], k[few], v[few], seeds, 0.1,
                                                       scale, ns)[0]),
            "k4f": (lambda: fl.flash_fwd(q, k, v, scale, ns)[0],
                    lambda: fl.flash_fwd_plain(q[few], k[few], v[few], scale, ns)[0]),
            # the one-sweep mode (bf16 K5f): K4f's function in one sweep
            "k5f": (lambda: fs.flash_stream_fwd(q, k, v, scale, ns)[0],
                    lambda: fs.flash_stream_fwd_plain(q[few], k[few], v[few], scale, ns)[0]),
        }
        for kern in ("head", "stream"):
            calls.update({f"k1f_{kern}_rate{r}": (
                lambda r=r, kern=kern: fq.flash_qkv_fwd(qkv, h, dh, scale, ns, seeds, r,
                                                        kernel=kern)[0],
                lambda r=r: fq.flash_qkv_fwd_plain(qkv[few], h, dh, scale, ns, seeds, r)[0])
                for r in (0.0, 0.1)})
            if which == "fwd":
                continue
            calls.update({
                **{f"k1b_{kern}_rate{r}": (
                    lambda r=r, kern=kern: fq.flash_qkv_bwd(qkv, lse1[r], gm, h, dh, scale, ns,
                                                            seeds, r, kernel=kern),
                    lambda r=r: fq.flash_qkv_bwd_plain(qkv[few], lse1[r][few], gm[few], h, dh,
                                                       scale, ns, seeds, r))
                   for r in (0.0, 0.1)},
                f"k3b_{kern}_rate0.1": (
                    lambda kern=kern: fd.flash_dropout_bwd(q, k, v, lse3, do, seeds, 0.1, scale,
                                                           ns, kernel=kern)[0],
                    lambda: fd.flash_dropout_bwd_plain(q[few], k[few], v[few], lse3[few],
                                                       do[few], seeds, 0.1, scale, ns)[0]),
                f"k4b_{kern}": (
                    lambda kern=kern: fl.flash_bwd(q, k, v, o4, lse4, do, scale, ns,
                                                   kernel=kern)[0],
                    lambda: fl.flash_bwd_plain(q[few], k[few], v[few], o4[few], lse4[few],
                                               do[few], scale, ns)[0]),
            })
        if which == "all":  # K5q and K5kv (dk compared), one streaming kernel each
            calls.update({
                "k5q": (lambda: fs.flash_stream_dq(*k5),
                        lambda: fs.flash_stream_dq_plain(*k5_few)),
                "k5kv": (lambda: fs.flash_stream_dkv(*k5)[0],
                         lambda: fs.flash_stream_dkv_plain(*k5_few)[0]),
            })
        calls = {c: f for c, f in calls.items()  # no whole-head kernel where a head does not fit
                 if "_head" not in c or fits[c.split("_")[0]]}
        plain = {kernel: p() for kernel, (_, p) in calls.items()}
        times = {name: {} for name in built}
        for name in built + built[::-1]:
            use(name)
            for kernel, (call, _) in calls.items():
                times[name].setdefault(kernel, []).append(time_ms(call))
        first = None
        for name in built:
            use(name)
            outs = {kernel: call() for kernel, (call, _) in calls.items()}
            errs = {kernel: (out[few].float() - plain[kernel].float()).abs().max().item()
                    for kernel, out in outs.items()}
            first = first or outs
            same = {kernel: bool(torch.equal(out, first[kernel])) for kernel, out in outs.items()}
            print(json.dumps({"variant": name, "shape": [b, h, n, dh], "num_special": ns,
                              "ms": times[name], "max_abs_err": errs,
                              f"equal_bits_to_{built[0]}": same}), flush=True)
            del outs
    for src in SOURCES:
        _build._libs.pop(src, None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
