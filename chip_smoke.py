#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``eavit_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU and the
CUDA toolkit:

    python3 chip_smoke.py

It imports nothing of JAX or of ``eavit_tpu``. Phases, each of which exits
non-zero on failure:

1. Build every kernel under ``eavit_tpu_torch/csrc`` with nvcc (sm_90a).
2. Kernels: each kernel at the shapes the paths give it (the acting shapes
   of 64 frames, the training shapes of 256), against its plain torch
   version on the same inputs, with the tolerance printed beside the
   error; times of the kernel, the plain version and, where one exists, the
   PyTorch call that computes the same function; the least time the card
   could take (``bound_ms``). The backward kernels are also held to torch
   autograd through the plain forward at rate 0.1, which proves that they
   replay the forward's masks.
3. Acting path, shared-patch-stream mode: the flagship configuration of
   ``bench.py:flagship_cfg`` (dim 256, depth 3, 8 heads x 32, MLP 1024,
   bf16, pallas_qkv attention, fused FFN) on 64 synthetic envs x 128 steps:
   ``RNDAgent`` on CUDA, obs-RMS seeding, ``DeviceRolloutCollector.collect``
   (the collector ``train`` runs on a host env) and ``prepare_batch``. The launch counts are reset before ``collect`` and
   read after it: K1f and K2f must each show 3 layers x 129 forwards. The
   network's output on a small input must agree with the same network run
   on the CPU, where the kernels take their plain versions.
4. The same acting path in the exact stacked mode (2B x 197 tokens).
5. Training path, shared stream, full width: ``train.train`` for two
   iterations (64 x 128 rollout, then 4 epochs x 32 minibatches of Adam),
   with the launch counts reset before and read after (per iteration 387 +
   384 forwards and 384 backwards of each kernel). Then: every metric
   finite, ``train/loss`` equal to the sum of its parts, the checkpoint
   loaded into a fresh agent (policy and ``rnd_pred`` moved, ``rnd_target``
   did not, ``global_step`` = 2 x 8,192), one more iteration in pieces for
   the timing split, the gradient of the whole network on 8 frames against
   a copy on the CPU (plain versions, same kernel seeds), and a short
   greedy episode of ``eval.evaluate`` from the checkpoint.
6. Training path, exact stacked mode: ``train.train`` for one iteration
   with ``Epoch = 1`` (96 launches of each backward kernel).
7. Flash kernels of ``AttentionImpl = pallas``: K4f / K4b (``ops/flash``,
   rate 0) and K3f / K3b (``ops/flash_dropout``, rate 0.1), the forwards on
   the streaming tensor-core template, at the acting
   shapes ``[64, 8, 198, 32]`` / ``[128, 8, 197, 32]`` and the training
   shapes ``[256, 8, 198, 32]`` / ``[512, 8, 197, 32]`` in bf16, and once in
   float32, against their plain versions; the backward kernels also against
   torch autograd through the plain forward and for equal bits twice; K3r
   bit for bit against the plain Philox. Times beside the bound and beside
   ``F.scaled_dot_product_attention`` (forward, and its backward) with the
   same boolean mask at rate 0, timed as a yardstick and never called by
   the port.
8. The acting path of phases 3-4 with ``AttentionImpl = pallas``: K3f 387
   launches per rollout (dropout is live at act time), K1f and K4f none.
9. Training with ``AttentionImpl = pallas``: the whole-network gradient
   check (float32 and bf16); ``train.train`` for one shared iteration with
   ``Epoch = 4`` (K3f 387 + 384, K3b 384, K4 none), the checkpoint, one
   iteration in pieces for the timing split, and ``evaluate``, whose
   deterministic forwards run K4f (3 per step) and no K3f; one stacked
   iteration with ``Epoch = 1``.
10. Training at ``ViTlucidrains_dropout = 0`` with ``AttentionImpl =
    pallas``, shared, ``Epoch = 1``: K4f 387 + 96, K4b 96, K3 none.
11. KV-streaming kernels of ``AttentionImpl = pallas_stream``: K5f, K5kv and
    K5q (``ops/flash_stream``; K5kv first, on a fresh delta, which no kernel
    may write) at the acting and training shapes of both
    modes, the patch-4 minibatch ``[256, 8, 443, 32]``, the JAX package's
    own K5 check shapes and the long sequences of its microbenchmark (N up
    to 3,137 at ``Dh`` = 64), in bf16 and once in float32, against their
    plain versions and for equal bits twice; times (float32 too) beside the
    bound, the plain version, ``F.scaled_dot_product_attention`` with the
    same mask (forward, and its backward beside K5q + K5kv) and K4 (its
    backward on the kernel the shape picks and on the streaming one); the
    backward Function in float32 and bf16 against torch autograd through the
    plain forward; each kernel's shared memory at ``Dh`` 16 / 32 / 64 in
    each dtype, which does not depend on N. The bf16 K5f runs the one-sweep
    mode of the tensor-core forward ``csrc/attn_fwd_mma.cuh`` (the online
    softmax, p as hi + lo bf16 terms) and is timed beside K4f, the same
    template's two sweeps; the bf16 K5q and K5kv run the dq and the dk/dv
    kernel of the tensor-core ``csrc/attn_bwd_mma.cuh`` (p and ds as hi +
    lo bf16 terms, the caller's delta); the float32 K5 runs
    ``flash_stream.cuh``.
12. The acting path of phases 3-4 with ``AttentionImpl = pallas_stream``:
    K5f 387 launches per rollout, dropout on the attention output outside
    the kernel, K1, K3 and K4 none.
13. Training with ``AttentionImpl = pallas_stream``: the whole-network
    gradient check (float32 and bf16); ``train.train`` for one shared
    iteration with ``Epoch = 4`` (K5f 387 + 384, K5q and K5kv 384 each), the
    checkpoint, one iteration in pieces, ``evaluate`` (3 K5f per step); one
    stacked iteration with ``Epoch = 1`` (K5q and K5kv 96 each).
14. Patch 4 (441 patches, N = 443 shared): one ``train.train`` iteration
    with ``Epoch = 1`` on ``pallas_stream``, finite, with its launch counts
    and frames/s; then one minibatch step of 4 frames on ``pallas`` and
    ``pallas_qkv`` at each long sequence of ``ROUTE_STEPS``: patch 4 in bf16
    and in float32 (``pallas`` at dropout 0.1 and 0) and patch 3 (N = 786) in
    bf16: finite gradients, through the kernels the wrappers pick at that
    length (the streaming ones past N = 256 and in float32).
15. ``long_n``: each of the six attention functions of K1, K3 and K4 on its
    streaming kernel, bf16 and float32, launched once at ``[16, 8, N, 32]``
    for N = 786 and 1,766 and held to its plain version, timed beside the
    bytes bound, the plain version and SDPA (bf16), with its shared memory,
    which does not depend on N.
16. ``determinism``: after the gradient checks, the same loss and backward
    twice on each route and dtype, the allocator's free memory filled with
    NaN bytes, then random bytes, before each run: every kernel output the
    network's wrappers return must have equal bits in both runs; the spread
    of the network's gradient between them is printed, with the parameters
    whose gradient differs (PyTorch's own ops, not the port's kernels).
17. ``device_env`` (the zero-host path): ``train.train`` on
    ``configs/synthetic_device_flagship.conf`` at full width, cut to
    ``ObsNormStep = 1`` and two iterations, with its launch counts; a resume
    from its checkpoint that brings back the env's ever-visited rooms; one
    iteration in pieces: ``collect`` with no host sync (counted under
    ``torch.cuda.set_sync_debug_mode``), K1f and K2f 387 launches a
    rollout, K1b and K2b 384 an update, the rollout equal bit for bit to the
    port's device env stepped on the CPU with the card's actions,
    ``collect_s`` and ``update_s`` beside the host-env iteration of phase 5;
    then one iteration of ``configs/maze_exploration.conf`` cut to 16 envs
    x 32 steps (its xla route launches no kernel).
18. ``continuous`` (ROADMAP.md Queue 1, item 5): ``configs/
    pendulum_continuous.conf`` at full width with ``UseNoisyNet = True`` on
    ``ContinuousSmokeEnv`` (Pendulum's dynamics and interface after the
    port's classic-control stack, frames from the angle; no gymnasium), 64
    envs x 128 steps: the warm-up (none under PPO), ``collect`` (K1f and
    K2f 387 launches) and one update of 4 epochs x 8 minibatches of 1,024
    frames (K1f, K2f, K1b and K2b 96 each), timed; finite actions [T, N, 1]
    with their log-probs, the tanh mean in [-1, 1], ``log_std`` after the
    update; the gradient of the network on 8 frames at dropout 0 with one
    NoisyLinear noise given to both copies, against the CPU copy within
    1.2e-6 (float32) and 5.3e-4 (bf16).
19. ``modified_rnd``: ``configs/synthetic_device_flagship.conf`` with
    ``TrainMethod = modified_RND``, ``UseNoisyNet = True`` and ``ObsNormStep
    = 1`` through ``train.train`` for two iterations, its launches counted
    (the next-obs embedding pass: 3 layers x 4 chunks of 2,048 frames of K1f
    and K2f at rate 0, in the warm-up and in each update); one iteration in
    pieces: ``collect`` with no host sync, the embedding pass alone, the
    update with its peak memory; the gradient check of phase 18 for the
    network and the ``MlpTrunk`` RND predictor. Before the training phases,
    K1f and K2f run at the shapes of item 5 (the embedding pass's chunk of
    2,048 frames at rate 0, the 1,024-frame minibatch at rate 0.1) against
    their plain versions, timed beside their bounds.
20. ``ssl_byol`` (Queue 1 item 7): the flagship with ``representationLearningMethod
    = BYOL``, ``SSL_pretraining = True`` and ``SSLEpochs = 1``, the heads at
    their defaults (projection hidden 4,096, size 256, decay 0.99,
    coefficient 0.01), through ``train.train`` for one PPO iteration after
    the pretraining: its launch counts (a pretraining minibatch runs 4
    forwards and 2 backwards a layer, an evaluation minibatch 4 forwards, an
    update minibatch 1 + 4 and 1 + 2), finite losses, ``train/loss`` the sum
    of its parts with the representation term, the SSL modules and the
    target through a checkpoint; one iteration in pieces (pretraining epoch,
    ``collect``, ``update``, peak memory, the minibatch step beside phase
    5's); one EMA step with equal bits to target * decay + online * (1 -
    decay) and no gradient on the target; the augmentation on the card
    against the CPU; the gradient of the joint loss on 8 frames at dropout 0
    against the CPU copy with one set of augment parameters given to both
    (float32 1.2e-6 with K2 plain and 2^-16 with every kernel; bf16 5.3e-4).
21. ``ssl_barlow``: the same with Barlow Twins at its defaults (projector
    8,192 x 3, lambda 0.0051) and ``Epoch = 1`` (2 forwards and 2 backwards
    a layer a pretraining minibatch, 1 + 2 and 1 + 2 an update minibatch).
22. ``remat`` (item 10): one flagship minibatch step of 256 frames at
    dropout 0.1 under ``EncoderRemat = none``, ``full`` and ``dots`` on
    ``pallas_qkv`` and on ``pallas``: the policy network's gradients under
    ``full`` and ``dots`` with the bits of ``none``, the forward kernels
    launched once more a layer, the step's peak memory and time, and its
    device time and the card's busy share from ``torch.profiler``.
23. ``device_rollout`` (Queue 1 item 4): the flagship's host-env rollout by
    ``RolloutCollector``, serial ``DeviceRolloutCollector`` (what
    ``train.train`` runs on the host-env path) and pipelined
    ``DeviceRolloutCollector`` (``AsyncEnvPool = True``: two half fleets of
    32 frames, K1f and K2f 2 x 3 x 129 launches): each one's launches,
    ``collect_s`` and the card's busy share of a collect; the serial rollout
    equal bit for bit to ``RolloutCollector``'s on one seed, the pipelined
    one in lockstep with the env; then K1f and K2f at the half act's shape
    against their plain versions.
24. ``hg`` (item 8): the HF-flavour ``DualTokenViTHG`` at ``ViTHGConfig``'s
    defaults (hidden 1,024, 12 layers, 16 heads of 64, intermediate 3,072,
    patch 12: 51 tokens) with the flagship's other settings through
    ``train.train`` for one iteration, launches exact (1,548 of K1f and K2f a
    rollout, 1,536 of K1f, K2f, K1b and K2b an update), one iteration in
    pieces (``collect_s``, ``update_s``, frames/s, update peak memory, the
    card's busy share of a minibatch step) and ``evaluate``; K1f and K1b
    whole-head at ``Dh`` 64 and K2f / K2b on the split path at (1,024,
    3,072) at its shapes, rates 0 and 0.1, against their plain versions and
    beside their bounds, SDPA and the float32 chain; one minibatch step on
    ``pallas`` (K4) and ``pallas_stream`` (K5); the gradient on 8 frames
    against the CPU copy at ``HG_GRAD_CRITERIA``, and the bf16 one against
    a float32 CPU copy at ``HG_BF16_REFERENCE``.
25. ``dp`` (item 9, ``eavit_tpu_torch/parallel/dp.py``): an NCCL group of
    one; the flagship on ``pallas_qkv`` through ``train.train`` for two
    iterations without the group and with it, in turns, in cuDNN's
    deterministic mode: parameters, optimizer state, normalisers and
    metrics equal bit for bit, K1f, K1b, K2f and K2b launched as in the
    ``train`` line, both arms' frames/s; then two gloo ranks spawned on this
    card (``cuda:0``, 32 envs each, ``Epoch = 1``) for two iterations: equal
    replicas, equal pooled metrics, and ``obs_rms`` pooled over the two
    ranks' next-obs equal to one ``rms_update`` over both. ``python3
    chip_smoke.py --only dp`` runs the build and this phase alone.

K1f, K1b, K3b and K4b have two bf16 kernels each: the whole-head forms
(``csrc/attn_fwd_head.cuh``, ``csrc/attn_bwd_head.cuh``), which the wrappers
run where a head fits in shared memory and N <= 256 (the flagship's 198),
and the
streaming tensor-core templates (``csrc/attn_fwd_mma.cuh``,
``csrc/attn_bwd_mma.cuh``), which take any N and which K3f and K4f run at
every N; float32 runs the streaming CUDA-core template of
``csrc/flash_stream.cuh``. Each kernel counts under its own launch key (the
streaming ones as ``*_stream``). K2f (``csrc/fused_ffn.cu``) and K2b
(``csrc/fused_ffn_bwd.cu``) run their products on the tensor cores too, a
float32 operand as hi + lo bf16 terms; their rows give the bound of that
work (three bf16 products per float32 one) beside the float32 CUDA cores'
bound. Phase 1 logs every tensor-core kernel's registers and spills from
ptxas (K5's, K2f's and K2b's too) and fails on a spill at ``Dh`` <= 32, and
on any spill of K5f, K2f or K2b; phase 2 times K1f at the act shapes and at
the minibatch shape (beside SDPA on the same head-split tensors and mask),
K2f at both act row counts and the minibatch's in both dtypes, with equal
bits twice and zeros exactly where K2r's mask2 drops (beside the float32
chain ``F.layer_norm``, ``F.linear``, ``F.gelu``, ``F.linear`` at rate 0,
timed as a yardstick that no one PyTorch call replaces), and the
streaming K1f, K1b, K3b and K4b are timed at the same flagship shapes;
phase 7 runs K4b at the patch-4 minibatch too; after phase 11 the
cancellation check runs once at the flagship minibatch (keys that are
nearly equal, so that dq nearly cancels: K3b, K4b and K5q, which keep pd
and ds in float32 as two bf16 terms, must err at most a tenth as much as
the dq that rounding ds to bf16 gives), then the ``widths`` line: K2f and
K2b at (rows, dim, hidden) = (37, 40, 100), (1,000, 384, 1,536), (512, 768,
3,072), (256, 1,024, 4,096), (256, 1,280, 5,120) and (37, 1,031, 100), and
each attention function at ``Dh`` 24, 48, 96 (zero-padded to 32, 64, 128)
and 128, in bf16 and float32, each call launching its kernel once, held to
its plain version and timed. A spill at ``Dh`` 128 is reported, not failed.
No wrapper runs its plain
version on the card: every row of a
kernel phase is logged only after the call it times launched the kernel
exactly once.

The last lines are the ``{"kernels": [...]}`` summary, the card's name and
power limit as nvidia-smi reports them, and ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import copy
import json
import os
import re
import subprocess
import sys
import tempfile
import time

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s of HBM3 and FLOP/s by type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
DEPTH, NUM_ENVS, NUM_STEP = 3, 64, 128
EPOCH, MINI_BATCH = 4, 32
MB_FRAMES = NUM_ENVS * NUM_STEP // MINI_BATCH  # 256 frames in a minibatch
SEED = 0  # of the random weights and the dropout streams
KERNEL_SEEDS = (0x1234ABCD, 0x0BADF00D)  # seed words of the kernel comparisons


def log(kind: str, **fields) -> None:
    print(json.dumps({"phase": kind, **fields}), flush=True)


def gpu_name_power() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()


def time_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls (CUDA
    events; warm L2, as on the path, where the producer just wrote the
    input)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(bytes_moved: float, flops: float, dtype: str):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def tensor_core_bound_ms(bytes_moved: float, flops: float, dtype: str):
    """``bound_ms`` of K2's products on the bf16 tensor cores: a float32
    product as three bf16 products (its operands as hi + lo terms, hi hi +
    hi lo + lo hi), a bf16 one as one."""
    return bound_ms(bytes_moved, (3 if dtype == "float32" else 1) * flops, "bfloat16")


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def once(mod, name: str, call):
    """``call()``, which must launch the kernel ``name`` of ``mod`` exactly
    once: a kernel row is logged only for a call that ran its kernel."""
    before = mod.launches[name]
    out = call()
    check(mod.launches[name] == before + 1,
          f"{name}: {mod.launches[name] - before} launches in one call, expected 1")
    return out


def ptxas_report(build_log: str):
    """``{source: {entry: {registers, stack, spill_stores, spill_loads}}}``
    from the ``-Xptxas -v`` output of ``_build.build_all``."""
    out, src, entry = {}, None, None
    for line in build_log.splitlines():
        if line.startswith("== "):
            src, entry = line[3:].strip(), None
            out.setdefault(src, {})
        elif m := re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)",
                            line):
            entry = m.group(1)
            out[src].setdefault(entry, {})
        elif entry and (m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                                       r"(\d+) bytes spill loads", line)):
            out[src][entry].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                                   spill_loads=int(m.group(3)))
        elif entry and (m := re.search(r"Used (\d+) registers", line)):
            out[src][entry]["registers"] = int(m.group(1))
    return out


def mma_ptxas(report, source: str, kind: str):
    """The tensor-core kernels of one kind (``"fwd"``, ``"bwd"`` or
    ``"ffn"``) in one source, as ``{"Dh32 fwd split dropout": {...}}`` (K5f's
    ``"Dh32 fwd split one sweep"``) or ``{"Dh32 dq rounded dropout": {...},
    "Dh32 dkv rounded dropout": ...}``, the whole-head kernels' as ``"Dh32 fwd
    head ..."`` and ``"Dh32 bwd head ..."``, K2f's as ``"fused_ffn_fwd
    float32 dropout"``, K2b's as
    ``"fused_ffn_bwd_dx float32"`` (and ``_dw``, ``split_planes``,
    ``stage_planes``), the split path's products as ``"wg_gemm EpiHidden
    bfloat16 n128 x2"`` (epilogue, dtype, tile columns, blocks an SM, `` mn``
    for MN-major operands) and its row kernels as ``"wide_rows bfloat16
    bwd"``, ``"wide_ln_bwd float32"``, ``"split_planes_t bfloat16"``. The dq kernel's last
    template argument is its row term (``common.cuh`` ``RowTerm``: 0 given, as
    K5q takes it, 1 delta from O, 2 rowsum), named " given", " delta" or
    nothing."""
    flags = lambda *bits: (" rounded" if bits[0] == "1" else " split") + (  # noqa: E731
        " dropout" if bits[1] == "1" else "") + (" delta" if bits[2:] == ("1",) else "")
    row_term = {"0": " given", "1": " delta", "2": ""}
    rows = {}
    for entry, info in report.get(source, {}).items():
        if kind == "fwd" and (m := re.search(
                r"attn_fwd_mma_kernelILi(\d+)ELb([01])ELb([01])ELb([01])E", entry)):
            rows[f"Dh{m.group(1)} fwd" + flags(m.group(2), m.group(3)) +
                 (" one sweep" if m.group(4) == "1" else "")] = info
        elif kind == "ffn" and (m := re.search(
                r"fused_ffn_fwd_kernelI(f|13__nv_bfloat16)Lb([01])E", entry)):
            rows[f"fused_ffn_fwd {'float32' if m.group(1) == 'f' else 'bfloat16'}" +
                 (" dropout" if m.group(2) == "1" else "")] = info
        elif kind == "ffn" and (m := re.search(
                r"(fused_ffn_bwd_dx|fused_ffn_bwd_dw|split_planes|stage_planes)_kernel"
                r"I(f|13__nv_bfloat16|Lb[01])E", entry)):
            rows[f"{m.group(1)} " + {"f": "float32", "13__nv_bfloat16": "bfloat16",
                                     "Lb1": "float32", "Lb0": "bfloat16"}[m.group(2)]] = info
        elif kind == "ffn" and (m := re.search(
                r"wg_gemm_kernelILi([12])ELi(\d+)ELi([12])ELb([01])ELb([01])ELb[01]E"
                r"NS_\d+(Epi[A-Za-z0-9]+?)(?:I(f|13__nv_bfloat16)E)?E", entry)):
            rows[f"wg_gemm {m.group(6)} {'float32' if m.group(1) == '2' else 'bfloat16'} "
                 f"n{m.group(2)} x{m.group(3)}" + (" mn" if m.group(4) == "1" else "")] = info
        elif kind == "ffn" and (m := re.search(
                r"(wide_rows|wide_ln_bwd|split_planes_t)_kernelI(f|13__nv_bfloat16|Lb[01])"
                r"(?:Lb([01])E)?", entry)):
            rows[f"{m.group(1)} " + {"f": "float32", "13__nv_bfloat16": "bfloat16",
                                     "Lb1": "float32", "Lb0": "bfloat16"}[m.group(2)] +
                 (" bwd" if m.group(3) == "1" else "")] = info
        elif kind == "fwd" and (m := re.search(r"attn_fwd_head_kernelILi(\d+)ELb([01])E", entry)):
            rows[f"Dh{m.group(1)} fwd head rounded" + (
                " dropout" if m.group(2) == "1" else "")] = info
        elif kind == "bwd" and (m := re.search(
                r"attn_bwd_head_kernelILi(\d+)ELb([01])ELb([01])ELb([01])E", entry)):
            rows[f"Dh{m.group(1)} bwd head" + flags(m.group(2), m.group(3), m.group(4))] = info
        elif kind == "bwd" and (m := re.search(
                r"attn_dq_mma_kernelILi(\d+)ELb([01])ELb([01])ELi([012])E", entry)):
            rows[f"Dh{m.group(1)} dq" + flags(m.group(2), m.group(3)) +
                 row_term[m.group(4)]] = info
        elif kind == "bwd" and (m := re.search(
                r"attn_dkv_mma_kernelILi(\d+)ELb([01])ELb([01])E", entry)):
            rows[f"Dh{m.group(1)} dkv" + flags(m.group(2), m.group(3))] = info
    return rows


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def _ffn_params(torch, dev, d, hid, seed):
    g = torch.Generator().manual_seed(seed)
    f = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    params = tuple(p.to(dev) for p in (
        1.0 + 0.1 * f(d), 0.1 * f(d), f(hid, d) / d ** 0.5, 0.1 * f(hid),
        f(d, hid) / hid ** 0.5, 0.1 * f(d)))
    return params, f


def k1f_rows(torch, fq, dev, use: str, b: int, n: int, ns: int, rates,
             heads: int = 8, dh: int = 32):
    """K1f on ``[b, n, 3 * heads * dh]`` bf16 at each rate of ``rates``
    against its plain version (one bf16 rounding of o, 1e-4 on lse, equal
    bits twice), timed beside the plain version, the bound and SDPA on the
    same head-split tensors and mask at rate 0: ``{("flash_qkv_fwd", use, n,
    rate): row}``."""
    import torch.nn.functional as F

    from eavit_tpu_torch.ops.attention import dual_query_allowed

    seeds, rows = KERNEL_SEEDS, {}
    g = torch.Generator().manual_seed(n + b)
    qkv = torch.randn(b, n, 3 * heads * dh, generator=g).to(dev, torch.bfloat16)
    q, k, v = (t.reshape(b, n, heads, dh).transpose(1, 2).contiguous()
               for t in qkv.split(heads * dh, dim=-1))
    mask = dual_query_allowed(n, n, ns, dev) if ns else None
    lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask), 50)
    del q, k, v
    for rate in rates:
        args = (heads, dh, dh ** -0.5, ns, seeds, rate)
        o, lse = once(fq, fq.fwd_kernel(n, dh, qkv.dtype), lambda: fq.flash_qkv_fwd(qkv, *args))
        po, plse = fq.flash_qkv_fwd_plain(qkv, *args)
        torch.cuda.synchronize()
        err = (o.float() - po.float()).abs().max().item()
        lse_err = (lse - plse).abs().max().item()
        tol = 1e-2 + 8e-3 * po.float().abs().max().item()  # one bf16 rounding of o
        del po, plse
        ms = time_ms(torch, lambda: fq.flash_qkv_fwd(qkv, *args), 50)
        plain = time_ms(torch, lambda: fq.flash_qkv_fwd_plain(qkv, *args), 5)
        nbytes = 2 * qkv.numel() + 2 * o.numel() + 4 * lse.numel()
        bms, by = bound_ms(nbytes, 4.0 * b * heads * n * n * dh, "bfloat16")
        again = fq.flash_qkv_fwd(qkv, *args)
        same = bool(torch.equal(o, again[0]) and torch.equal(lse, again[1]))
        del again
        row = dict(kernel="flash_qkv_fwd", use=use, b=b, n=n, heads=heads, dim_head=dh,
                   num_special=ns, rate=rate, launched=fq.fwd_kernel(n, dh, qkv.dtype),
                   dtype="bfloat16", max_abs_err=err, tol=tol, lse_err=lse_err,
                   lse_tol=1e-4, deterministic=same, ms=ms, plain_ms=plain,
                   library_ms=lib_ms, bound_ms=bms, bound_by=by)
        log("kernel", **row)
        check(err <= tol and lse_err <= 1e-4 and same, f"flash_qkv_fwd {row}")
        rows[("flash_qkv_fwd", use, n, rate)] = row
    return rows


def ffn_chain_ms(torch, x32, dy32, params, eps: float, dtype, backward: bool = True):
    """Device times of the chain of four PyTorch calls that computes K2f's
    function at rate 0 (``F.layer_norm``, ``F.linear``, exact ``F.gelu``,
    ``F.linear``) with input, parameters and products in ``dtype``, and of its
    autograd backward (one ``torch.autograd.grad`` over the seven inputs
    given ``dy``, the graph kept): yardsticks for K2f and K2b that the port
    never calls. ``(forward ms, backward ms or None)``."""
    import torch.nn.functional as F

    d = x32.shape[-1]
    leaves = [t.detach().to(dtype).requires_grad_() for t in (x32, *params)]

    def chain():
        x, lw, lb, w1, b1, w2, b2 = leaves
        return F.linear(F.gelu(F.linear(F.layer_norm(x, (d,), lw, lb, eps), w1, b1)), w2, b2)

    with torch.no_grad():
        fwd = time_ms(torch, chain, 20)
    if not backward:
        return fwd, None
    y, dy = chain(), dy32.to(dtype)
    bwd = time_ms(torch, lambda: torch.autograd.grad(y, leaves, dy, retain_graph=True), 10)
    del y
    return fwd, bwd


def k2f_rows(torch, ff, kp, dev, r: int, dtypes, rates, d: int = 256, hid: int = 1024,
             eps: float = 1e-5):
    """K2f on ``r`` rows at dim ``d``, hidden ``hid`` for each dtype and rate
    against its plain version (1e-4 of scale in float32, one bf16 rounding
    in bf16, equal bits twice, zeros exactly where K2r's mask2 drops), timed
    beside the plain version and the bound. Beside the float32 rows the
    float32 rate-0 chain of four PyTorch calls (LayerNorm, Linear, exact
    GELU, Linear; "highest" precision), and beside every row the same chain
    in bf16 (``ffn_chain_ms``), yardsticks the port never calls: no one
    PyTorch call computes K2f. ``{("fused_ffn_fwd", r, dtype, rate): row}``."""
    seeds, rows = KERNEL_SEEDS, {}
    params, f = _ffn_params(torch, dev, d, hid, r)
    x32 = f(r, d).to(dev)
    chain_ms, chain_bf16_ms = (ffn_chain_ms(torch, x32, x32, params, eps, dt, False)[0]
                               for dt in (torch.float32, torch.bfloat16))
    for dtype in dtypes:
        x = x32.to(dtype)
        for rate in rates:
            y = once(ff, "fused_ffn_fwd",
                     lambda: ff.fused_ffn(x, *params, seeds=seeds, rate=rate, eps=eps))
            p = ff.fused_ffn_fwd_plain(x, *params, seeds=seeds, rate=rate, eps=eps)
            torch.cuda.synchronize()
            err = (y.float() - p.float()).abs().max().item()
            scale = p.float().abs().max().item()
            tol = 1e-4 * scale if dtype == torch.float32 else 1e-2 + 8e-3 * scale
            same = bool(torch.equal(y, ff.fused_ffn(x, *params, seeds=seeds, rate=rate,
                                                    eps=eps)))
            masks = True
            if rate:  # zero exactly where K2r's mask2 drops
                _, m2 = ff.fused_ffn_bits(r, d, hid, seeds, dev)
                masks = bool(torch.equal(y == 0, m2 >= kp.keep_threshold(rate)))
            del p
            ms = time_ms(torch, lambda: ff.fused_ffn(x, *params, seeds=seeds,
                                                     rate=rate, eps=eps), 20)
            plain = time_ms(torch, lambda: ff.fused_ffn_fwd_plain(
                x, *params, seeds=seeds, rate=rate, eps=eps), 5)
            name = str(dtype).split(".")[-1]
            nbytes = 2 * x.numel() * x.element_size() + 4 * sum(t.numel() for t in params)
            # two products on the tensor cores, a float32 one as three bf16
            # products; beside it the bound on the float32 CUDA cores
            bms, by = tensor_core_bound_ms(nbytes, 4.0 * r * d * hid, name)
            row = dict(kernel="fused_ffn_fwd", rows=r, dim=d, hidden=hid, dtype=name,
                       rate=rate, fused=ff.fused_widths(d, hid, True),
                       max_abs_err=err, tol=tol, deterministic=same, masks_equal_k2r=masks,
                       ms=ms, plain_ms=plain, library_ms=None, bound_ms=bms, bound_by=by,
                       cuda_core_bound_ms=bound_ms(nbytes, 4.0 * r * d * hid, name)[0],
                       chain_bf16_ms=chain_bf16_ms,
                       **({"chain_ms": chain_ms, "chain": "F.layer_norm, F.linear, "
                           "F.gelu, F.linear; float32 rate 0 (chain_bf16_ms: bf16)"}
                          if dtype == torch.float32 else {}))
            log("kernel", **row)
            check(err <= tol and same and masks, f"fused_ffn_fwd {row}")
            rows[("fused_ffn_fwd", r, name, rate)] = row
        del x
    return rows


def kernel_phase(torch, fq, ff, kp, dev):
    heads, seeds = 8, KERNEL_SEEDS
    rows = {}

    # K1f at both act shapes and the shared minibatch, rate 0 and 0.1 (the
    # paths run 0.1); SDPA on the same head-split tensors and mask at rate 0
    for use, b, n, ns in (("act", NUM_ENVS, 198, 2), ("act", 2 * NUM_ENVS, 197, 0),
                          ("train", MB_FRAMES, 198, 2)):
        rows.update(k1f_rows(torch, fq, dev, use, b, n, ns, (0.0, 0.1)))

    # K2f at both act row counts and the minibatch's; float32 is what the
    # path feeds it
    d, hid = 256, 1024
    for r in (NUM_ENVS * 198, 2 * NUM_ENVS * 197, MB_FRAMES * 198):
        rows.update(k2f_rows(torch, ff, kp, dev, r, (torch.float32, torch.bfloat16),
                             (0.0, 0.1)))

    # K1r and K2r: bit for bit, and the keep rate at 0.1 within 4 sigma
    thresh = kp.keep_threshold(0.1)
    p_keep = thresh / (1 << 24)

    def keep_ok(bits):
        sigma = (p_keep * (1 - p_keep) / bits.numel()) ** 0.5
        keep = (bits < thresh).double().mean().item()
        return keep, abs(keep - p_keep) < 4 * sigma

    b, n = NUM_ENVS, 198
    bits = once(fq, "flash_qkv_bits", lambda: fq.flash_qkv_bits(b, heads, n, seeds, dev))
    plain_bits = fq.flash_qkv_bits_plain(b, heads, n, seeds, dev)
    equal = bool(torch.equal(bits, plain_bits))
    keep, keep_good = keep_ok(bits)
    bms, by = bound_ms(4 * bits.numel(), 0.0, "bfloat16")
    row = dict(kernel="flash_qkv_bits", b=b, n=n, equal=equal, keep=keep,
               max_abs_err=0.0 if equal else float("nan"),
               ms=time_ms(torch, lambda: fq.flash_qkv_bits(b, heads, n, seeds, dev), 20),
               plain_ms=time_ms(torch, lambda: fq.flash_qkv_bits_plain(
                   b, heads, n, seeds, dev), 3),
               library_ms=None, bound_ms=bms, bound_by=by)
    log("kernel", **row)
    check(equal and keep_good, f"flash_qkv_bits {row}")
    rows["flash_qkv_bits"] = row

    r = NUM_ENVS * 198
    m1, m2 = once(ff, "fused_ffn_bits", lambda: ff.fused_ffn_bits(r, d, hid, seeds, dev))
    p1, p2 = ff.fused_ffn_bits_plain(r, d, hid, seeds, dev)
    equal = bool(torch.equal(m1, p1) and torch.equal(m2, p2))
    keep, keep_good = keep_ok(torch.cat([m1.reshape(-1), m2.reshape(-1)]))
    bms, by = bound_ms(4 * (m1.numel() + m2.numel()), 0.0, "bfloat16")
    row = dict(kernel="fused_ffn_bits", rows=r, equal=equal, keep=keep,
               max_abs_err=0.0 if equal else float("nan"),
               ms=time_ms(torch, lambda: ff.fused_ffn_bits(r, d, hid, seeds, dev), 20),
               plain_ms=time_ms(torch, lambda: ff.fused_ffn_bits_plain(
                   r, d, hid, seeds, dev), 3),
               library_ms=None, bound_ms=bms, bound_by=by)
    log("kernel", **row)
    check(equal and keep_good, f"fused_ffn_bits {row}")
    rows["fused_ffn_bits"] = row
    return rows


def k1b_rows(torch, fq, dev, b: int, n: int, ns: int, heads: int = 8, dh: int = 32):
    """K1b on ``[b, n, 3 * heads * dh]`` bf16 at rates 0 and 0.1 against its
    plain version (one bf16 rounding), timed beside the plain version, the
    bound and SDPA's backward on the same head-split tensors and mask at rate
    0: ``{("flash_qkv_bwd", n, rate): row}``."""
    import torch.nn.functional as F

    from eavit_tpu_torch.ops.attention import dual_query_allowed

    seeds, rows = KERNEL_SEEDS, {}
    g = torch.Generator().manual_seed(n + 1)
    qkv = torch.randn(b, n, 3 * heads * dh, generator=g).to(dev, torch.bfloat16)
    do = torch.randn(b, n, heads * dh, generator=g).to(dev, torch.bfloat16)
    # yardstick: the backward of SDPA alone (same mask, rate 0)
    q, k, v = (t.reshape(b, n, heads, dh).transpose(1, 2).contiguous().requires_grad_()
               for t in qkv.split(heads * dh, dim=-1))
    mask = dual_query_allowed(n, n, ns, dev) if ns else None
    o_lib = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
    do_lib = do.reshape(b, n, heads, dh).transpose(1, 2).contiguous()
    lib_ms = time_ms(torch, lambda: torch.autograd.grad(
        o_lib, (q, k, v), do_lib, retain_graph=True), 20)
    del o_lib, q, k, v
    key = fq.bwd_kernel(n, dh, qkv.dtype)
    for rate in (0.0, 0.1):
        args = (heads, dh, dh ** -0.5, ns, seeds, rate)
        _, lse = fq.flash_qkv_fwd(qkv, *args)
        dqkv = once(fq, key, lambda: fq.flash_qkv_bwd(qkv, lse, do, *args))
        plain = fq.flash_qkv_bwd_plain(qkv, lse, do, *args)
        torch.cuda.synchronize()
        err = (dqkv.float() - plain.float()).abs().max().item()
        tol = 1e-2 + 8e-3 * plain.float().abs().max().item()  # one bf16 rounding
        del plain
        ms = time_ms(torch, lambda: fq.flash_qkv_bwd(qkv, lse, do, *args), 10)
        plain_ms = time_ms(torch, lambda: fq.flash_qkv_bwd_plain(
            qkv, lse, do, *args), 2, warmup=1)
        nbytes = 2 * (2 * qkv.numel() + do.numel()) + 4 * lse.numel()
        bms, by = bound_ms(nbytes, 10.0 * b * heads * n * n * dh, "bfloat16")
        row = dict(kernel="flash_qkv_bwd", b=b, n=n, heads=heads, dim_head=dh,
                   num_special=ns, rate=rate, launched=key,
                   dtype="bfloat16", max_abs_err=err, tol=tol, ms=ms,
                   plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms, bound_by=by)
        log("kernel", **row)
        check(err <= tol, f"flash_qkv_bwd {row}")
        rows[("flash_qkv_bwd", n, rate)] = row
    return rows


def k2b_rows(torch, ff, dev, r: int, dtypes, d: int = 256, hid: int = 1024,
             eps: float = 1e-5):
    """K2b on ``r`` rows at dim ``d``, hidden ``hid`` for each dtype at rates 0
    and 0.1 against its plain version, timed beside the plain version, K2f at
    the same shape, the bound and the bf16 chain's autograd backward
    (``ffn_chain_ms``; float32 rows also the float32 chain's): ``{("fused_ffn_bwd",
    r, dtype, rate): row}``. Weight gradients sum tens of thousands of rows,
    so each output is judged against its own maximum."""
    seeds, rows = KERNEL_SEEDS, {}
    names = ("dx", "dln_w", "dln_b", "dw1", "db1", "dw2", "db2")
    params, f = _ffn_params(torch, dev, d, hid, r + 1)
    x32, dy32 = f(r, d).to(dev), f(r, d).to(dev)
    chain = {dt: ffn_chain_ms(torch, x32, dy32, params, eps, dt)
             for dt in {torch.bfloat16, *dtypes}}
    for dtype in dtypes:
        x, dy = x32.to(dtype), dy32.to(dtype)
        name = str(dtype).split(".")[-1]
        for rate in (0.0, 0.1):
            call = lambda: ff.fused_ffn_bwd(x, *params[:5], dy, seeds, rate, eps)  # noqa: E731
            out = once(ff, "fused_ffn_bwd", call)
            plain = ff.fused_ffn_bwd_plain(x, *params[:5], dy, seeds, rate, eps)
            torch.cuda.synchronize()
            rel = {k: ((a.float() - p.float()).abs().max()
                       / p.float().abs().max()).item()
                   for k, a, p in zip(names, out, plain)}
            # float32: 1e-4 of each output's maximum. bf16 input: one bf16
            # rounding of dx; the float32 weight gradients see other
            # roundings of dh and gd where a sum lands on a boundary
            tol = {k: 1e-4 if dtype == torch.float32 else
                   (1.2e-2 if k == "dx" else 2e-3) for k in names}
            again = call()
            same = all(torch.equal(a, b_) for a, b_ in zip(out, again))
            err = (out[0].float() - plain[0].float()).abs().max().item()
            del plain, again
            ms = time_ms(torch, call, 5)
            plain_ms = time_ms(torch, lambda: ff.fused_ffn_bwd_plain(
                x, *params[:5], dy, seeds, rate, eps), 2, warmup=1)
            fwd_ms = time_ms(torch, lambda: ff.fused_ffn_fwd(
                x, *params, seeds, rate, eps), 10)
            nbytes = 3 * x.numel() * x.element_size() + 4 * sum(
                t.numel() for t in params) + 4 * sum(t.numel() for t in out[1:])
            # five products: fc1 recomputed, dW2, dgd, dW1, du (the fc2
            # output is needed by no gradient), on the tensor cores, a
            # float32 one as three bf16 products; beside it the bound of
            # the same products on the float32 CUDA cores
            bms, by = tensor_core_bound_ms(nbytes, 10.0 * r * d * hid, name)
            row = dict(kernel="fused_ffn_bwd", rows=r, dim=d, hidden=hid, dtype=name,
                       rate=rate, fused=ff.fused_widths(d, hid, False),
                       max_abs_err=err, max_rel_err=rel, rel_tol=tol,
                       deterministic=same, ms=ms, plain_ms=plain_ms,
                       library_ms=None, bound_ms=bms, bound_by=by,
                       cuda_core_bound_ms=bound_ms(nbytes, 10.0 * r * d * hid, name)[0],
                       fwd_ms_at_this_shape=fwd_ms, chain_bwd_bf16_ms=chain[torch.bfloat16][1],
                       chain_bwd_ms=chain[dtype][1],
                       chain="autograd backward of F.layer_norm, F.linear, F.gelu, "
                             "F.linear in the row's dtype (chain_bwd_ms) and in bf16; rate 0")
            log("kernel", **row)
            check(all(rel[k] <= tol[k] for k in names) and same, f"fused_ffn_bwd {row}")
            rows[("fused_ffn_bwd", r, name, rate)] = row
    return rows


def train_kernel_phase(torch, fq, ff, dev):
    """K1b and K2b against their plain versions, and K2f timed again, at the
    shapes one minibatch of 256 frames gives them (K1f's minibatch row is
    phase 2's)."""
    seeds, rows = KERNEL_SEEDS, {}
    for b, n, ns in ((MB_FRAMES, 198, 2), (2 * MB_FRAMES, 197, 0)):
        rows.update(k1b_rows(torch, fq, dev, b, n, ns))
    # K2b; float32 is what the path feeds it
    for r, dtypes in ((MB_FRAMES * 198, (torch.float32, torch.bfloat16)),
                      (2 * MB_FRAMES * 197, (torch.float32,))):
        rows.update(k2b_rows(torch, ff, dev, r, dtypes))

    # explicit backward kernels against torch autograd through the PLAIN
    # forward, float32, rate 0.1: the backward replays the forward's masks
    g = torch.Generator().manual_seed(5)
    qkv = torch.randn(4, 37, 3 * 4 * 16, generator=g).to(dev).requires_grad_()
    do = torch.randn(4, 37, 4 * 16, generator=g).to(dev)
    o, _ = fq.flash_qkv_fwd_plain(qkv, 4, 16, 0.25, 2, seeds, 0.1)
    (ref,) = torch.autograd.grad(o, qkv, do)
    x = qkv.detach().clone().requires_grad_()
    fq.flash_mha_qkv(x, 4, 16, seeds=seeds, rate=0.1, num_special=2).backward(do)
    err = (x.grad - ref).abs().max().item()
    tol = 1e-4 * ref.abs().max().item()
    log("autograd", kernel="flash_qkv_bwd", max_abs_err=err, tol=tol)
    check(err <= tol, "flash_qkv: Function backward vs autograd of the plain forward")

    params, f = _ffn_params(torch, dev, 64, 96, 9)
    leaves = [f(130, 64).to(dev).requires_grad_()] + [p.requires_grad_() for p in params]
    dy = f(130, 64).to(dev)
    ref = torch.autograd.grad(ff.fused_ffn_fwd_plain(*leaves, seeds, 0.1), leaves, dy)
    mine = [t.detach().clone().requires_grad_() for t in leaves]
    ff.fused_ffn(*mine, seeds=seeds, rate=0.1).backward(dy)
    rel = max(((a.grad - b_).abs().max() / b_.abs().max()).item()
              for a, b_ in zip(mine, ref))
    log("autograd", kernel="fused_ffn_bwd", max_rel_err=rel, tol=1e-4)
    check(rel <= 1e-4, "fused_ffn: Function backward vs autograd of the plain forward")
    return rows


# ---------------------------------------------------------------------------
# the widths line: every width eavit_tpu takes (ROADMAP.md Queue 3, fault 6)
# ---------------------------------------------------------------------------

FFN_WIDTHS = ((37, 40, 100), (37, 37, 100), (1000, 384, 1536), (512, 768, 3072),
              (256, 1024, 4096), (256, 1280, 5120), (37, 1031, 100))
HEAD_WIDTHS = (24, 48, 96, 128)


def widths_phase(torch, ff, fq, fl, fd, fs, dev):
    """K2f and K2b at ragged and wide widths (the split path, past 1,024
    too), and every attention function at head widths between the
    instantiated 16 / 32 / 64 / 128 (zero-padded to the next) and at 128, in
    bf16 and float32: each call launches its kernel once, is held to its
    plain version (one bf16 rounding, or 1e-4 of scale in float32; K2b each
    output against its own maximum) and is timed."""
    seeds, rate, out = KERNEL_SEEDS, 0.1, []

    def held(what, got, want, dtype, rel=False, tols=None):
        errs = []
        for i, (a, p) in enumerate(zip(got, want)):
            scale = p.float().abs().max().item()
            err = (a.float() - p.float()).abs().max().item()
            if tols is not None:
                tol = tols[i] * scale
            elif dtype == torch.bfloat16:
                tol = 1e-2 + 8e-3 * scale
            else:
                tol = 1e-4 * max(1.0 if not rel else scale, scale)
            errs.append(err / max(tol, 1e-30))
            check(a.shape == p.shape and err <= tol, f"widths: {what} output {i} err {err} "
                  f"tol {tol}")
        return max(errs)

    for rows, d, hid in FFN_WIDTHS:
        params, f = _ffn_params(torch, dev, d, hid, rows + d)
        x32, dy32 = f(rows, d).to(dev), f(rows, d).to(dev)
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            x, dy = x32.to(dtype), dy32.to(dtype)
            y = once(ff, "fused_ffn_fwd", lambda: ff.fused_ffn_fwd(x, *params, seeds, rate))
            worst = held(f"fused_ffn_fwd {rows}x{d}->{hid} {name}", (y,),
                         (ff.fused_ffn_fwd_plain(x, *params, seeds, rate),), dtype, rel=True)
            out.append(dict(kernel="fused_ffn_fwd", rows=rows, dim=d, hidden=hid, dtype=name,
                            launches=1, worst_err_over_tol=worst, ms=time_ms(
                                torch, lambda: ff.fused_ffn_fwd(x, *params, seeds, rate), 5)))
            g = once(ff, "fused_ffn_bwd",
                     lambda: ff.fused_ffn_bwd(x, *params[:5], dy, seeds, rate))
            tols = [1e-4] * 7 if dtype == torch.float32 else [1.2e-2] + [2e-3] * 6
            worst = held(f"fused_ffn_bwd {rows}x{d}->{hid} {name}", g,
                         ff.fused_ffn_bwd_plain(x, *params[:5], dy, seeds, rate), dtype,
                         tols=tols)
            out.append(dict(kernel="fused_ffn_bwd", rows=rows, dim=d, hidden=hid, dtype=name,
                            launches=1, worst_err_over_tol=worst, ms=time_ms(
                                torch, lambda: ff.fused_ffn_bwd(x, *params[:5], dy, seeds,
                                                                rate), 5)))
    torch.cuda.empty_cache()

    b, h, n, ns = 8, 4, 198, 2
    for dh in HEAD_WIDTHS:
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[-1]
            g = torch.Generator().manual_seed(dh)
            q, k, v, do = (torch.randn(b, h, n, dh, generator=g).to(dev, dtype)
                           for _ in range(4))
            scale = dh ** -0.5
            merged = lambda t: t.transpose(1, 2).reshape(b, n, h * dh)  # noqa: E731
            qkv = torch.cat([merged(t) for t in (q, k, v)], dim=-1).contiguous()
            gm = merged(do).contiguous()
            a1 = (h, dh, scale, ns, seeds, rate)
            lse1 = fq.flash_qkv_fwd_plain(qkv, *a1)[1]
            o4, lse4 = fl.flash_fwd_plain(q, k, v, scale, ns)
            lse3 = fd.flash_dropout_fwd_plain(q, k, v, seeds, rate, scale, ns)[1]
            a5 = (q, k, v, lse4, fs.stream_delta(o4, do), do, scale, ns)
            a3 = (q, k, v, lse3, do, seeds, rate, scale, ns)
            cases = (
                (fq, fq.fwd_kernel(n, dh, dtype), lambda: fq.flash_qkv_fwd(qkv, *a1)[:1],
                 lambda: fq.flash_qkv_fwd_plain(qkv, *a1)[:1]),
                (fq, fq.bwd_kernel(n, dh, dtype), lambda: (fq.flash_qkv_bwd(qkv, lse1, gm, *a1),),
                 lambda: (fq.flash_qkv_bwd_plain(qkv, lse1, gm, *a1),)),
                (fl, "flash_fwd", lambda: fl.flash_fwd(q, k, v, scale, ns)[:1],
                 lambda: (o4,)),
                (fl, fl.bwd_kernel(n, dh, dtype),
                 lambda: fl.flash_bwd(q, k, v, o4, lse4, do, scale, ns),
                 lambda: fl.flash_bwd_plain(q, k, v, o4, lse4, do, scale, ns)),
                (fd, "flash_dropout_fwd",
                 lambda: fd.flash_dropout_fwd(q, k, v, seeds, rate, scale, ns)[:1],
                 lambda: fd.flash_dropout_fwd_plain(q, k, v, seeds, rate, scale, ns)[:1]),
                (fd, fd.bwd_kernel(n, dh, dtype), lambda: fd.flash_dropout_bwd(*a3),
                 lambda: fd.flash_dropout_bwd_plain(*a3)),
                (fs, "flash_stream_fwd", lambda: fs.flash_stream_fwd(q, k, v, scale, ns)[:1],
                 lambda: fs.flash_stream_fwd_plain(q, k, v, scale, ns)[:1]),
                (fs, "flash_stream_dq", lambda: (fs.flash_stream_dq(*a5),),
                 lambda: (fs.flash_stream_dq_plain(*a5),)),
                (fs, "flash_stream_dkv", lambda: fs.flash_stream_dkv(*a5),
                 lambda: fs.flash_stream_dkv_plain(*a5)),
            )
            for mod, key, call, plain in cases:
                got = once(mod, key, call)
                worst = held(f"{key} Dh {dh} {name}", got, plain(), dtype)
                out.append(dict(kernel=key, shape=[b, h, n, dh], dtype=name, launches=1,
                                worst_err_over_tol=worst, ms=time_ms(torch, call, 5)))
    log("widths", cases=len(out), results=out)
    return out


# ---------------------------------------------------------------------------
# phase 7: the flash kernels of AttentionImpl = pallas
# ---------------------------------------------------------------------------


# (use, B, N, num_special, dtype) of the flash kernels: the acting and
# minibatch shapes of both modes, the patch-4 minibatch, and once float32
FLASH_SHAPES = (("act", NUM_ENVS, 198, 2, "bfloat16"), ("act", 2 * NUM_ENVS, 197, 0, "bfloat16"),
                ("train", MB_FRAMES, 198, 2, "bfloat16"),
                ("train", 2 * MB_FRAMES, 197, 0, "bfloat16"),
                ("train_patch4", MB_FRAMES, 443, 2, "bfloat16"),
                ("act", NUM_ENVS, 198, 2, "float32"))


def flash_kernel_phase(torch, fl, fd, fq, kp, dev):
    """K4f, K4b, K3f, K3b at the pallas path's shapes against their plain
    versions, timed; K3r bit for bit; the backward Functions against torch
    autograd through the plain forwards."""
    import torch.nn.functional as F

    from eavit_tpu_torch.ops.attention import dual_query_allowed

    heads, dh, seeds, rate = 8, 32, KERNEL_SEEDS, 0.1
    scale = dh ** -0.5
    rows = {}

    def err_tol(out, ref, dtype):
        err = (out.float() - ref.float()).abs().max().item()
        big = ref.float().abs().max().item()
        # bf16: one rounding of the output (2^-8); f32: another sum order
        tol = 1e-2 + 8e-3 * big if dtype == torch.bfloat16 else 1e-4 * max(1.0, big)
        return err, tol

    for use, b, n, ns, dname in FLASH_SHAPES:
        dtype = getattr(torch, dname)
        g = torch.Generator().manual_seed(b + n)
        q, k, v, do = (torch.randn(b, heads, n, dh, generator=g).to(dev, dtype)
                       for _ in range(4))
        timed = dtype == torch.bfloat16
        mask = dual_query_allowed(n, n, ns, dev) if ns else None
        bhn, numel, esize = b * heads * n, q.numel(), q.element_size()
        nn_flops = 2.0 * b * heads * n * n * dh  # one [N, N] x [N, Dh] product
        lib_fwd = time_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask), 20) if timed else None
        fwds = {
            "flash_fwd": (fl, lambda: fl.flash_fwd(q, k, v, scale, ns),
                          lambda: fl.flash_fwd_plain(q, k, v, scale, ns), 0.0),
            "flash_dropout_fwd": (
                fd, lambda: fd.flash_dropout_fwd(q, k, v, seeds, rate, scale, ns),
                lambda: fd.flash_dropout_fwd_plain(q, k, v, seeds, rate, scale, ns), rate),
        }
        saved = {}
        for name, (mod, fwd, plain, r) in fwds.items():
            o, lse = once(mod, name, fwd)
            po, plse = plain()
            torch.cuda.synchronize()
            err, tol = err_tol(o, po, dtype)
            lse_err = (lse - plse).abs().max().item()
            del po, plse
            saved[name] = (o, lse)
            # q, k, v read once, o written once, lse f32
            bms, by = bound_ms(4 * numel * esize + 4 * bhn, 2 * nn_flops, dname)
            row = dict(kernel=name, use=use, b=b, n=n, num_special=ns, rate=r,
                       dtype=dname, max_abs_err=err, tol=tol, lse_err=lse_err,
                       lse_tol=1e-4, bound_ms=bms, bound_by=by, library_ms=lib_fwd)
            if timed:
                row.update(ms=time_ms(torch, fwd, 20),
                           plain_ms=time_ms(torch, plain, 3, warmup=1))
            log("kernel", **row)
            check(err <= tol and lse_err <= 1e-4, f"{name} {row}")
            rows[(name, use, n, dname)] = row
        if use == "act" and timed:
            continue

        lib_bwd = None
        if timed:  # yardstick: the backward of SDPA alone (same mask, rate 0)
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            o_lib = F.scaled_dot_product_attention(*leaves, attn_mask=mask)
            lib_bwd = time_ms(torch, lambda: torch.autograd.grad(
                o_lib, leaves, do, retain_graph=True), 10)
            del o_lib, leaves
        o4, lse4 = saved["flash_fwd"]
        lse3 = saved["flash_dropout_fwd"][1]
        bwds = {
            # q, k, v, o, dO and lse read, dq, dk, dv written
            "flash_bwd": (fl, lambda: fl.flash_bwd(q, k, v, o4, lse4, do, scale, ns),
                          lambda: fl.flash_bwd_plain(q, k, v, o4, lse4, do, scale, ns),
                          0.0, 8),
            # no O: q, k, v, dO and lse read, dq, dk, dv written
            "flash_dropout_bwd": (
                fd, lambda: fd.flash_dropout_bwd(q, k, v, lse3, do, seeds, rate, scale, ns),
                lambda: fd.flash_dropout_bwd_plain(q, k, v, lse3, do, seeds, rate, scale, ns),
                rate, 7),
        }
        for name, (mod, bwd, plain, r, tensors) in bwds.items():
            key = mod.bwd_kernel(n, dh, dtype)  # float32: the streaming kernel
            out = once(mod, key, bwd)
            ref = plain()
            again = bwd()
            torch.cuda.synchronize()
            errs = [err_tol(a, p, dtype) for a, p in zip(out, ref)]
            same = all(torch.equal(a, b_) for a, b_ in zip(out, again))
            del ref, again
            # five products: scores recomputed, dV, dP, dQ, dK
            bms, by = bound_ms(tensors * numel * esize + 4 * bhn, 5 * nn_flops, dname)
            row = dict(kernel=key, use=use, b=b, n=n, num_special=ns, rate=r,
                       dtype=dname, max_abs_err=max(e for e, _ in errs),
                       errs_dq_dk_dv=[e for e, _ in errs], tols_dq_dk_dv=[t for _, t in errs],
                       deterministic=same, bound_ms=bms, bound_by=by, library_ms=lib_bwd)
            if timed:
                row.update(ms=time_ms(torch, bwd, 10),
                           plain_ms=time_ms(torch, plain, 2, warmup=1))
            log("kernel", **row)
            check(all(e <= t for e, t in errs) and same, f"{name} {row}")
            rows[(name, use, n, dname)] = row
        del q, k, v, do, saved, o4, lse4, lse3

    # K3r: bit for bit, and the keep rate at 0.1 within 4 sigma
    b, n = NUM_ENVS, 198
    thresh = kp.keep_threshold(rate)
    p_keep = thresh / (1 << 24)
    bits = once(fd, "flash_dropout_bits", lambda: fd.dropout_raw_bits(b, heads, n, seeds, dev))
    plain_bits = kp.raw_bits24(b * heads * n * n, seeds, 0, dev).reshape(b, heads, n, n)
    equal = bool(torch.equal(bits, plain_bits))
    keep = (bits < thresh).double().mean().item()
    keep_good = abs(keep - p_keep) < 4 * (p_keep * (1 - p_keep) / bits.numel()) ** 0.5
    bms, by = bound_ms(4 * bits.numel(), 0.0, "bfloat16")
    row = dict(kernel="flash_dropout_bits", b=b, n=n, equal=equal, keep=keep,
               max_abs_err=0.0 if equal else float("nan"),
               ms=time_ms(torch, lambda: fd.dropout_raw_bits(b, heads, n, seeds, dev), 20),
               plain_ms=time_ms(torch, lambda: fd.dropout_raw_bits_plain(
                   b, heads, n, seeds, dev), 3),
               library_ms=None, bound_ms=bms, bound_by=by)
    log("kernel", **row)
    check(equal and keep_good, f"flash_dropout_bits {row}")
    rows["flash_dropout_bits"] = row
    del bits, plain_bits

    # the Functions' backward kernels against autograd through the PLAIN
    # forward, float32: K3b replays the forward's mask, K4b uses its O
    g = torch.Generator().manual_seed(5)
    q, k, v, do = (torch.randn(4, 4, 37, 16, generator=g).to(dev) for _ in range(4))
    for r, (name, plain_fwd) in {
        0.0: ("flash_bwd", lambda *t: fl.flash_fwd_plain(*t, 0.25, 2)),
        rate: ("flash_dropout_bwd",
               lambda *t: fd.flash_dropout_fwd_plain(*t, seeds, rate, 0.25, 2)),
    }.items():
        ref_in = [t.clone().requires_grad_() for t in (q, k, v)]
        ref = torch.autograd.grad(plain_fwd(*ref_in)[0], ref_in, do)
        mine = [t.clone().requires_grad_() for t in (q, k, v)]
        fd.flash_attention_dropout(*mine, seeds, r, scale=0.25, num_special=2).backward(do)
        err = max((a.grad - b_).abs().max().item() for a, b_ in zip(mine, ref))
        tol = 1e-4 * max(b_.abs().max().item() for b_ in ref)
        log("autograd", kernel=name, max_abs_err=err, tol=tol)
        check(err <= tol, f"{name}: Function backward vs autograd of the plain forward")
    return rows


def cancellation_check(torch, fq, fd, fl, fs, dev):
    """At the flagship minibatch ``[256, 8, 198, 32]``, rate 0.1, with keys
    ``8 + 0.01 noise`` in bf16: the rows of ds sum to 0, so ``dq = ds k``
    nearly cancels. K3b keeps pd and ds in float32 (two bf16 terms each): its
    dq must err against the plain version at most a tenth as much as the dq
    that rounding ds to bf16 gives, which is the plain K1b on the same
    inputs (K1 rounds pd and ds and draws the same mask). The K1b kernel must
    match that plain K1b at one bf16 rounding. K4b (rate 0, delta from the
    forward's O) is held the same way against its plain version with ds
    rounded to bf16 before ``ds k``, each on its whole-head and its
    streaming kernel, and so is K5q (delta given, from K5f's rounded O)."""
    import numpy as np

    b, h, n, dh, ns = MB_FRAMES, 8, 198, 32, 2
    scale, seeds, rate = dh ** -0.5, KERNEL_SEEDS, 0.1
    rng = np.random.default_rng(12)
    q, v, do, noise = (torch.from_numpy(rng.standard_normal((b, h, n, dh)).astype(np.float32))
                       for _ in range(4))
    q, k, v, do = (t.to(dev, torch.bfloat16) for t in (q, 8.0 + 0.01 * noise, v, do))

    def merged(t):  # [B, H, N, Dh] -> [B, N, H*Dh]
        return t.transpose(1, 2).reshape(b, n, h * dh).contiguous()

    _, lse = fd.flash_dropout_fwd(q, k, v, seeds, rate, scale, ns)
    dq_plain = fd.flash_dropout_bwd_plain(q, k, v, lse, do, seeds, rate, scale, ns)[0]
    qkv, g = torch.cat([merged(t) for t in (q, k, v)], dim=-1), merged(do)
    args = (h, dh, scale, ns, seeds, rate)
    k1_plain = fq.flash_qkv_bwd_plain(qkv, lse, g, *args)
    dq_rounded = k1_plain[..., :h * dh].reshape(b, n, h, dh).transpose(1, 2)
    err_rounded = (dq_rounded.float() - dq_plain.float()).abs().max().item()
    k1_tol = 1e-2 + 8e-3 * k1_plain.float().abs().max().item()  # one bf16 rounding
    for choice in ("head", "stream"):
        dq = fd.flash_dropout_bwd(q, k, v, lse, do, seeds, rate, scale, ns, kernel=choice)[0]
        k1 = fq.flash_qkv_bwd(qkv, lse, g, *args, kernel=choice)
        torch.cuda.synchronize()
        err = (dq.float() - dq_plain.float()).abs().max().item()
        k1_err = (k1.float() - k1_plain.float()).abs().max().item()
        log("cancellation", kernel=choice, shape=[b, h, n, dh], rate=rate, k3b_dq_err=err,
            rounded_ds_dq_err=err_rounded,
            ratio=err / err_rounded if err_rounded else None, ratio_tol=0.1,
            dq_max=dq_plain.float().abs().max().item(), k1b_err=k1_err, k1b_tol=k1_tol)
        check(err_rounded > 0 and err <= 0.1 * err_rounded,
              f"K3b ({choice}) dq error {err} vs {err_rounded} with ds rounded to bf16")
        check(k1_err <= k1_tol, f"K1b ({choice}) on cancelling keys: {k1_err} > {k1_tol}")
        del dq, k1
    del dq_plain, k1_plain, dq_rounded, qkv, g

    # K4b and K5q: the plain formulas (flash_bwd_plain, flash_stream_dq_plain)
    # in float32, once with ds as it is and once with ds rounded to bf16
    # before dq = ds k, both written in bf16 as the kernels write dq
    def plain_dq(o, lse):
        gf = do.float()
        p = torch.exp(fl.masked_scores(q, k, scale, ns) - lse[..., None])
        dp = torch.matmul(gf, v.float().transpose(-1, -2))
        ds = p * (dp - fs.stream_delta(o, do)[..., None]) * scale
        del p, dp
        dq_plain = torch.matmul(ds, k.float()).to(torch.bfloat16).float()
        dq_rounded = torch.matmul(ds.to(torch.bfloat16).float(), k.float())
        return dq_plain, (dq_rounded.to(torch.bfloat16).float() - dq_plain).abs().max().item()

    o, lse = fl.flash_fwd(q, k, v, scale, ns)
    o5, lse5 = fs.flash_stream_fwd(q, k, v, scale, ns)
    delta5 = fs.stream_delta(o5, do)
    for name, (o_, lse_), call in (
            ("flash_bwd head", (o, lse),
             lambda: fl.flash_bwd(q, k, v, o, lse, do, scale, ns, kernel="head")[0]),
            ("flash_bwd stream", (o, lse),
             lambda: fl.flash_bwd(q, k, v, o, lse, do, scale, ns, kernel="stream")[0]),
            ("flash_stream_dq", (o5, lse5),
             lambda: fs.flash_stream_dq(q, k, v, lse5, delta5, do, scale, ns))):
        dq_plain, err_rounded = plain_dq(o_, lse_)
        dq = call()
        torch.cuda.synchronize()
        err = (dq.float() - dq_plain).abs().max().item()
        log("cancellation", kernel=name, shape=[b, h, n, dh], rate=0.0,
            dq_err=err, rounded_ds_dq_err=err_rounded,
            ratio=err / err_rounded if err_rounded else None, ratio_tol=0.1,
            dq_max=dq_plain.abs().max().item())
        check(err_rounded > 0 and err <= 0.1 * err_rounded,
              f"{name} dq error {err} vs {err_rounded} with ds rounded to bf16")
        del dq, dq_plain


# ---------------------------------------------------------------------------
# phase 11: the KV-streaming kernels of AttentionImpl = pallas_stream
# ---------------------------------------------------------------------------

# (use, B, H, N, Dh, num_special): the acting and minibatch shapes of both
# modes at patch 6 and the shared minibatch at patch 4, the JAX package's own
# K5 check shapes (scripts/tpu_kernel_check.py:33) and the long sequences of
# scripts/attn_microbench.py:31-37
STREAM_SHAPES = (
    ("act", NUM_ENVS, 8, 198, 32, 2), ("act", 2 * NUM_ENVS, 8, 197, 32, 0),
    ("train", MB_FRAMES, 8, 198, 32, 2), ("train", 2 * MB_FRAMES, 8, 197, 32, 0),
    ("train_patch4", MB_FRAMES, 8, 443, 32, 2),
    ("jax_check", 7, 8, 197, 32, 2), ("jax_check", 16, 4, 130, 64, 2),
    ("jax_check", 4, 4, 640, 64, 2),
    ("long", 128, 8, 442, 32, 0), ("long", 64, 8, 785, 64, 0),
    ("long", 32, 8, 1765, 64, 0), ("long", 16, 8, 3137, 64, 0),
)


def allowed_pairs(n: int, ns: int) -> int:
    """(query, key) pairs the dual-query mask allows in one head."""
    return (n - ns) * (n - ns) + ns * (n - ns + 1) if ns else n * n


def stream_kernel_phase(torch, fs, fl, dev):
    """K5f, K5kv and K5q (in that order: K5kv first on a fresh delta, which
    K5q must leave bit for bit as it was) against their plain versions at
    every shape of ``STREAM_SHAPES`` in bf16 and once in float32, equal bits
    twice, timed beside the bound, the plain version, SDPA with the same mask
    and K4 (which takes every N too; its backward also on its streaming
    kernel, the same template as the bf16 K5q and K5kv); the backward
    Function in float32 and bf16 against torch autograd through the plain
    forward; the shared memory of each kernel in each dtype."""
    import torch.nn.functional as F

    from eavit_tpu_torch.ops import _build
    from eavit_tpu_torch.ops.attention import dual_query_allowed

    def err_tol(out, ref, dtype):
        err = (out.float() - ref.float()).abs().max().item()
        big = ref.float().abs().max().item()
        # bf16: one rounding of the output (2^-8); f32: another sum order
        tol = 1e-2 + 8e-3 * big if dtype == torch.bfloat16 else 1e-4 * max(1.0, big)
        return err, tol

    rows = {}
    cases = [(*c, torch.bfloat16) for c in STREAM_SHAPES] + [
        ("act", NUM_ENVS, 8, 198, 32, 2, torch.float32)]
    for use, b, h, n, dh, ns, dtype in cases:
        g = torch.Generator().manual_seed(b + n + dh)
        q, k, v, do = (torch.randn(b, h, n, dh, generator=g).to(dev, dtype)
                       for _ in range(4))
        scale, dname, timed = dh ** -0.5, str(dtype).split(".")[-1], dtype == torch.bfloat16
        # float32 (the CUDA-core template) is timed too, without yardsticks
        numel, esize, bhn = q.numel(), q.element_size(), b * h * n
        pair_flops = 2.0 * b * h * allowed_pairs(n, ns) * dh  # one [N, N] x [N, Dh] product
        iters = max(3, min(50, int(4e10 / pair_flops)))
        mask = dual_query_allowed(n, n, ns, dev) if ns else None

        o, lse = fs.flash_stream_fwd(q, k, v, scale, ns)
        delta = fs.stream_delta(o, do)
        delta_before = delta.clone()
        bargs = (q, k, v, lse, delta, do, scale, ns)
        calls = {  # kernel -> (kernel call, plain call, tensors moved, products)
            # q, k, v read, o written, lse f32
            "flash_stream_fwd": (lambda: fs.flash_stream_fwd(q, k, v, scale, ns),
                                 lambda: fs.flash_stream_fwd_plain(q, k, v, scale, ns),
                                 4 * numel * esize + 4 * bhn, 2),
            # q, k, v, dO, lse, delta read, dk, dv written; scores, dP, dV, dK
            "flash_stream_dkv": (lambda: fs.flash_stream_dkv(*bargs),
                                 lambda: fs.flash_stream_dkv_plain(*bargs),
                                 6 * numel * esize + 8 * bhn, 4),
            # q, k, v, dO, lse, delta read, dq written; scores, dP, dQ
            "flash_stream_dq": (lambda: (fs.flash_stream_dq(*bargs),),
                                lambda: (fs.flash_stream_dq_plain(*bargs),),
                                5 * numel * esize + 8 * bhn, 3),
        }
        lib = {"flash_stream_fwd": None, "bwd": None}
        k4 = {}
        if timed:  # yardsticks: SDPA with the same mask, and K4
            lib["flash_stream_fwd"] = time_ms(torch, lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask), iters)
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            o_lib = F.scaled_dot_product_attention(*leaves, attn_mask=mask)
            lib["bwd"] = time_ms(torch, lambda: torch.autograd.grad(
                o_lib, leaves, do, retain_graph=True), iters)
            del o_lib, leaves
            # K4b beside K5q + K5kv: both compute dq, dk and dv (K4b sums
            # delta from O itself), on the kernel the shape picks and on the
            # streaming one, the same template as K5q and K5kv in bf16
            k4["k4_fwd_ms"] = time_ms(torch, lambda: fl.flash_fwd(q, k, v, scale, ns), iters)
            k4["k4_bwd_ms"] = time_ms(torch, lambda: fl.flash_bwd(
                q, k, v, o, lse, do, scale, ns), iters)
            k4["k4_bwd_stream_ms"] = time_ms(torch, lambda: fl.flash_bwd(
                q, k, v, o, lse, do, scale, ns, kernel="stream"), iters)
        for name, (call, plain, nbytes, products) in calls.items():
            out = once(fs, name, call)
            ref = plain()
            again = call()
            torch.cuda.synchronize()
            errs = [err_tol(a, p, dtype) for a, p in zip(out, ref)]
            same = all(torch.equal(a, b_) for a, b_ in zip(out, again))
            # no kernel writes the caller's delta
            same = same and torch.equal(delta, delta_before)
            row = dict(kernel=name, use=use, b=b, h=h, n=n, dim_head=dh, num_special=ns,
                       dtype=dname, max_abs_err=max(e for e, _ in errs),
                       errs=[e for e, _ in errs], tols=[t for _, t in errs],
                       deterministic=same)
            if name == "flash_stream_fwd":  # errs: o, lse
                row.update(errs=errs[0][0], tols=errs[0][1], max_abs_err=errs[0][0],
                           lse_err=errs[1][0], lse_tol=1e-4)
                ok = errs[0][0] <= errs[0][1] and errs[1][0] <= 1e-4
            else:
                ok = all(e <= t for e, t in errs)
            del out, ref, again
            bms, by = bound_ms(nbytes, products * pair_flops, dname)
            row.update(bound_ms=bms, bound_by=by,
                       library_ms=lib[name if name in lib else "bwd"])
            row.update(ms=time_ms(torch, call, iters),
                       plain_ms=time_ms(torch, plain, 2, warmup=1),
                       **{key: t for key, t in k4.items()
                          if (key == "k4_fwd_ms") == (name == "flash_stream_fwd")})
            log("kernel", **row)
            check(ok and same, f"{name} {row}")
            rows[(name, use, n, dname)] = row
        del q, k, v, do, o, lse, delta, delta_before, bargs, calls
        torch.cuda.empty_cache()

    # the Function's backward kernels against autograd through the PLAIN
    # forward: float32 at 1e-4 of scale, bf16 at one bf16 rounding (the
    # kernels take delta from the rounded O, autograd from the unrounded one)
    g = torch.Generator().manual_seed(6)
    base = [torch.randn(4, 4, 150, 16, generator=g).to(dev) for _ in range(4)]
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, do = (t.to(dtype) for t in base)
        for ns in (0, 2):
            ref_in = [t.clone().requires_grad_() for t in (q, k, v)]
            ref = torch.autograd.grad(fs.flash_stream_fwd_plain(*ref_in, 0.25, ns)[0], ref_in,
                                      do)
            mine = [t.clone().requires_grad_() for t in (q, k, v)]
            fs.flash_attention_stream(*mine, scale=0.25, num_special=ns).backward(do)
            err = max((a.grad.float() - b_.float()).abs().max().item()
                      for a, b_ in zip(mine, ref))
            big = max(b_.float().abs().max().item() for b_ in ref)
            tol = 1e-4 * big if dtype == torch.float32 else 1e-2 + 8e-3 * big
            log("autograd", kernel="flash_stream_dq+flash_stream_dkv", num_special=ns,
                dtype=str(dtype).split(".")[-1], max_abs_err=err, tol=tol)
            check(err <= tol, "flash_stream: Function backward vs autograd of the plain forward")

    # shared memory: a function of Dh and the dtype alone, so every N runs;
    # the bf16 K5q and K5kv exceed 48 KB at Dh 64 and opt in (allow_smem)
    smem = {str(dt).split(".")[-1]: {name: {dh: fs.smem_bytes(name, dh, dt)
                                            for dh in _build.DIM_HEADS}
                                     for name in ("fwd", "dq", "dkv")}
            for dt in (torch.bfloat16, torch.float32)}
    log("smem", kernels="flash_stream", bytes_by_dim_head=smem, depends_on_n=False,
        longest_n_run=max(c[3] for c in STREAM_SHAPES), limit=_build.SMEM_LIMIT)
    check(all(0 < v_ <= _build.SMEM_LIMIT for by in smem.values() for d in by.values()
              for v_ in d.values()), f"flash_stream shared memory {smem}")
    return rows


# ---------------------------------------------------------------------------
# phases 3-4 and 8: the acting path
# ---------------------------------------------------------------------------


def flagship_cfg(shared: bool, attention: str = "pallas_qkv"):
    from eavit_tpu_torch.config import Config, EnvType, TrainMethod

    # bench.py:flagship_cfg (bench.py:290-324) with the shared-stream flag,
    # on the synthetic host envs that bench.py builds itself
    return Config(
        train_method=TrainMethod.ORIGINAL_RND, env_type=EnvType.SYNTHETIC,
        sticky_action=False, num_step=NUM_STEP,
        num_env_per_process=NUM_ENVS, epoch=EPOCH, mini_batch=MINI_BATCH, obs_norm_step=0,
        max_step_per_episode=4500, shared_patch_stream=shared, async_env_pool=False,
        attention_impl=attention, fused_ffn=True, seed=SEED,
    )


def attention_kernels(attention: str, dropout: bool):
    """The attention kernels a flagship model runs: ``(forward, backwards)``."""
    if attention == "pallas_qkv":
        return "flash_qkv_fwd", ("flash_qkv_bwd",)
    if attention == "pallas_stream":  # dropout on the output, outside the kernels
        return "flash_stream_fwd", ("flash_stream_dq", "flash_stream_dkv")
    if dropout:
        return "flash_dropout_fwd", ("flash_dropout_bwd",)
    return "flash_fwd", ("flash_bwd",)


def _counts(mods):
    return {k: v for m in mods for k, v in m.launches.items()}


def _reset(mods):
    for m in mods:
        m.reset_launches()


def check_counts(counts, expect, what: str) -> None:
    """Every kernel launched exactly as often as ``expect`` says, the rest
    never."""
    check(all(counts[k] == expect.get(k, 0) for k in counts),
          f"{what}: launches {counts}, expected {expect} and 0 of the rest")


def main_path(torch, mods, dev, shared: bool, attention: str = "pallas_qkv"):
    import numpy as np

    from eavit_tpu_torch.envs.synthetic import SyntheticVectorEnv
    from eavit_tpu_torch.models.layers import Rng
    from eavit_tpu_torch.rl.agent import RNDAgent
    from eavit_tpu_torch.rl.device_rollout import DeviceRolloutCollector

    mode = "shared" if shared else "stacked"
    cfg = flagship_cfg(shared, attention)
    check(cfg.vit.depth == DEPTH and cfg.vit.dim == 256 and cfg.compute_dtype == "bfloat16",
          "flagship width")
    env = SyntheticVectorEnv(cfg.num_env_per_process, seed=42,
                             max_episode_steps=cfg.max_step_per_episode)
    agent = RNDAgent(cfg, env.action_space_n)  # CUDA by default
    check(agent.device.type == "cuda", "agent on CUDA")
    state = agent.init_state(SEED)
    rng = Rng(SEED + 1, agent.device)
    collector = DeviceRolloutCollector(cfg, agent, env)
    states = env.reset()
    state = agent.update_obs_rms(state, collector._next_obs_of(states))

    # reference: the same network on the CPU, where the kernels take their
    # plain versions (deterministic forward on 8 frames)
    probe = torch.from_numpy(states[:8]).to(dev).float() / 255.0
    with torch.no_grad():
        out = agent.network(probe)
        cpu_net = copy.deepcopy(agent.network).to("cpu")
        ref = cpu_net(probe.cpu())
    ref_err = max((getattr(out, k).cpu() - getattr(ref, k)).abs().max().item()
                  for k in ("policy", "value_ext", "value_int", "features"))
    feat_scale = ref.features.abs().max().item()
    ref_tol = 2e-2 * max(1.0, feat_scale)  # bf16 Dense layers, other sum order
    log("reference", mode=mode, attention=attention, max_abs_err=ref_err, tol=ref_tol)
    check(ref_err <= ref_tol, f"{mode}: network on CUDA vs CPU plain path")
    del cpu_net

    torch.cuda.synchronize()
    _reset(mods)
    t0 = time.perf_counter()
    rollout, states = collector.collect(states, rng)
    torch.cuda.synchronize()
    collect_s = time.perf_counter() - t0

    frames = cfg.num_step * cfg.num_env_per_process
    next_obs_flat = rollout.next_obs.transpose(0, 1).reshape(
        (frames,) + tuple(rollout.next_obs.shape[2:]))
    t0 = time.perf_counter()
    agent.compute_intrinsic_reward(state, next_obs_flat)  # first call: cuDNN set-up
    torch.cuda.synchronize()
    intrinsic_first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    int_r = agent.compute_intrinsic_reward(state, next_obs_flat)
    torch.cuda.synchronize()
    intrinsic_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    new_state, batch, metrics = agent.prepare_batch(state, rollout)
    torch.cuda.synchronize()
    prepare_s = time.perf_counter() - t0
    counts = _counts(mods)  # the main path ends here

    # where a collect step goes: the act call alone (device work waited
    # for) and the host env step alone, each averaged over 20 calls
    t0 = time.perf_counter()
    for _ in range(20):
        agent.act(states, rng)[0].cpu()
    act_ms = (time.perf_counter() - t0) / 20 * 1e3
    actions = np.zeros(cfg.num_env_per_process, np.int64)
    t0 = time.perf_counter()
    for _ in range(20):
        env.step(actions)
    env_step_ms = (time.perf_counter() - t0) / 20 * 1e3

    finite = bool(torch.isfinite(batch.adv).all() and torch.isfinite(batch.ext_target).all()
                  and torch.isfinite(batch.int_target).all()
                  and torch.isfinite(batch.rnd_in).all() and torch.isfinite(int_r).all())
    per_rollout = cfg.vit.depth * (cfg.num_step + 1)
    expect = {attention_kernels(attention, cfg.vit.dropout > 0)[0]: per_rollout,
              "fused_ffn_fwd": per_rollout}
    log("main_path", mode=mode, attention=attention, envs=cfg.num_env_per_process, steps=cfg.num_step,
        frames=frames, collect_s=collect_s, frames_per_s=frames / collect_s,
        step_ms=collect_s / (cfg.num_step + 1) * 1e3, act_ms=act_ms,
        env_step_ms=env_step_ms, intrinsic_first_s=intrinsic_first_s,
        intrinsic_s=intrinsic_s, prepare_batch_s=prepare_s,
        adv_shape=list(batch.adv.shape), ext_target_shape=list(batch.ext_target.shape),
        int_target_shape=list(batch.int_target.shape), finite=finite,
        launches=counts, expected_launches=expect,
        int_reward_per_rollout=float(metrics["data/int_reward_per_rollout"]),
        episodes=collector.stats.num_episodes)
    check(finite, f"{mode}: finite advantages and targets")
    check(tuple(batch.adv.shape) == (frames,) and tuple(batch.ext_target.shape) == (frames,)
          and tuple(batch.int_target.shape) == (frames,), f"{mode}: shapes")
    check_counts(counts, expect, f"{mode}, {attention}: collect")
    check(int(new_state.obs_rms.count) > int(state.obs_rms.count), f"{mode}: obs_rms moved")
    return counts


# ---------------------------------------------------------------------------
# phases 5-6: the training path
# ---------------------------------------------------------------------------

LOSS_PARTS = ("train/actor_loss", "train/critic_loss", "train/entropy_loss",
              "train/rnd_loss")


def host_batch(torch, n: int, seed: int = SEED):
    """The fields of a ``TrainBatch`` of ``n`` random frames, on the host."""
    import numpy as np

    rng_np = np.random.default_rng(seed)
    return dict(
        states=torch.from_numpy(rng_np.integers(0, 256, (n, 4, 84, 84), dtype=np.uint8)),
        actions=torch.from_numpy(rng_np.integers(0, 5, n)),
        old_policy=torch.from_numpy(rng_np.standard_normal((n, 5)).astype(np.float32)),
        adv=torch.from_numpy(rng_np.standard_normal(n).astype(np.float32)),
        ext_target=torch.from_numpy(rng_np.standard_normal(n).astype(np.float32)),
        int_target=torch.from_numpy(rng_np.standard_normal(n).astype(np.float32)),
        rnd_in=torch.from_numpy(rng_np.standard_normal((n, 1, 84, 84)).astype(np.float32)),
    )


def ssl_host_batch(torch, n: int, seed: int = SEED):
    """``host_batch`` with frames that differ from one another: a level per
    frame and channel with noise on it. On white noise every frame has
    nearly one embedding, and the SSL heads' batch normalisation over those
    makes their gradient ill-conditioned."""
    import numpy as np

    rng_np = np.random.default_rng(seed + 14)
    level = rng_np.integers(30, 220, (n, 4, 1, 1))
    frames = np.clip(level + rng_np.integers(-30, 31, (n, 4, 84, 84)), 0, 255)
    return dict(host_batch(torch, n, seed), states=torch.from_numpy(frames.astype(np.uint8)))


def grad_check(torch, dev, compute_dtype: str, tol: float, attention: str = "pallas_qkv"):
    """Loss and gradients of the whole network and the RND predictor on one
    minibatch of 8 frames (shared stream), kernels on the card against a copy
    on the CPU (plain versions), both from ``SEED``. Kernel dropout is live
    at rate 0.1 with the same seed words on both sides (the device Philox
    equals the plain one). The 16-bit dropout layers outside the kernels draw
    from the device's own generator, which no CPU generator reproduces, so
    they are switched off in both copies (on ``pallas_stream`` that is all
    the attention's dropout); ``UpdateProportion = 1`` takes the RND mask out
    the same way."""
    from eavit_tpu_torch.ops import flash, flash_dropout, flash_qkv, flash_stream, fused_ffn

    mods = (flash_qkv, fused_ffn, flash, flash_dropout, flash_stream)
    host = host_batch(torch, 8)
    losses, grads = {}, {}
    for where in (dev, "cpu"):
        loss, g, _ = network_grads(torch, grad_agent(torch, where, attention, compute_dtype),
                                   host, mods)
        losses[str(where)] = float(loss)
        grads[str(where)] = torch.cat([t.float().reshape(-1).cpu() for t in g.values()])
    on_card = str(dev)
    rel = ((grads[on_card] - grads["cpu"]).norm() / grads["cpu"].norm()).item()
    loss_err = abs(losses[on_card] - losses["cpu"])
    loss_tol = tol * max(1.0, abs(losses["cpu"]))
    log("grad_check", mode="shared", attention=attention, compute_dtype=compute_dtype,
        frames=8, loss_cuda=losses[on_card], loss_cpu=losses["cpu"], loss_err=loss_err,
        loss_tol=loss_tol, grad_rel_err=rel, grad_rel_tol=tol,
        grad_elements=grads["cpu"].numel())
    check(loss_err <= loss_tol and rel <= tol,
          f"gradient of the whole network, {compute_dtype}: CUDA kernels vs CPU plain")


# ---------------------------------------------------------------------------
# determinism: equal bits in a repeat (ROADMAP.md Queue 3, fault 7)
# ---------------------------------------------------------------------------

KERNEL_FUNCS = {  # ops module -> its kernel wrappers that the network calls
    "flash_qkv": ("flash_qkv_fwd", "flash_qkv_bwd"),
    "fused_ffn": ("fused_ffn_fwd", "fused_ffn_bwd"),
    "flash": ("flash_fwd", "flash_bwd"),
    "flash_dropout": ("flash_dropout_fwd", "flash_dropout_bwd"),
    "flash_stream": ("flash_stream_fwd", "flash_stream_dq", "flash_stream_dkv"),
}


class KernelRecorder:
    """While open, every kernel wrapper of ``mods`` also keeps a copy of the
    tensors it returned, in call order: ``calls`` is ``[(name, (tensor,
    ...)), ...]``. The autograd Functions find the wrappers by their module
    names, so the network's own calls are recorded."""

    def __init__(self, mods):
        self.calls, self._patched = [], []
        for m in mods:
            for name in KERNEL_FUNCS[m.__name__.rsplit(".", 1)[1]]:
                self._patch(m, name)

    def _patch(self, m, name):
        f = getattr(m, name)

        def recorded(*args, **kw):
            out = f(*args, **kw)
            outs = out if isinstance(out, tuple) else (out,)
            self.calls.append((name, tuple(t.detach().clone() for t in outs
                                           if t is not None)))
            return out

        self._patched.append((m, name, f))
        setattr(m, name, recorded)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for m, name, f in self._patched:
            setattr(m, name, f)


def same_bits(torch, a, b) -> bool:
    """Equal shape, dtype and bytes (NaN payloads and the sign of 0 count)."""
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8)))


def poison_allocator(torch, dev, fill) -> None:
    """Fill memory that the caching allocator hands out next with the byte
    ``fill`` (0xFF reads as NaN in float32 and bf16), or with random bytes
    for ``None``: a kernel that reads memory it did not write then changes
    its output between repeats."""
    blocks = [torch.empty(64 << 20, dtype=torch.uint8, device=dev) for _ in range(16)]
    blocks += [torch.empty(256 << 10, dtype=torch.uint8, device=dev) for _ in range(256)]
    for b in blocks:
        if fill is None:
            b.random_(0, 256)
        else:
            b.fill_(fill)
    del blocks


def network_grads(torch, agent, host, mods, rng_seed: int = SEED + 7):
    """One loss and backward of ``agent`` on the frames ``host`` (as
    ``grad_check`` does): ``(loss, {parameter: gradient}, kernel calls)``."""
    from eavit_tpu_torch.models.layers import Rng
    from eavit_tpu_torch.rl.agent import TrainBatch

    dev = agent.device
    named = [(f"policy.{n}", p) for n, p in agent.network.named_parameters()]
    if agent.rnd_pred is not None:
        named += [(f"rnd_pred.{n}", p) for n, p in agent.rnd_pred.named_parameters()]
    if agent.ssl is not None:
        named += [(f"ssl.{n}", p) for n, p in agent.ssl.named_parameters()]
    for _, p in named:
        p.grad = None
    batch = TrainBatch(**{k: None if v is None else v.to(dev) for k, v in host.items()})
    n = batch.adv.shape[0]
    with KernelRecorder(mods) as rec:
        loss, _ = agent._loss(batch, torch.arange(n, device=dev), Rng(rng_seed, dev))
        loss.backward()
    # a parameter the loss does not reach (critic_int under PPO) gets zeros,
    # as in the agent's minibatch step
    return (loss.detach().clone(),
            {k: torch.zeros_like(p) if p.grad is None else p.grad.detach().clone()
             for k, p in named}, rec.calls)


def grad_agent(torch, dev, attention: str, compute_dtype: str):
    """The flagship agent of ``grad_check`` (shared stream, ``UpdateProportion
    = 1``, the 16-bit dropout layers off) on ``dev``, from ``SEED``."""
    from eavit_tpu_torch.models.layers import Dropout16
    from eavit_tpu_torch.rl.agent import RNDAgent

    cfg = flagship_cfg(True, attention).replace(update_proportion=1.0,
                                                compute_dtype=compute_dtype)
    agent = RNDAgent(cfg, 5, device=dev)
    agent.init_state(SEED)
    for m in agent.network.modules():
        if isinstance(m, Dropout16):
            m.rate = 0.0
    return agent


def compare_repeats(torch, runs):
    """What differs from the first of ``runs`` (``network_grads`` results):
    ``loss_equal``; ``kernels_differing`` ``{kernel: calls whose output bits
    differ}`` and ``kernel_spread`` (their largest difference over the
    output's largest value); ``params_differing`` ``{parameter: largest
    gradient difference over its largest value}`` and ``grad_spread`` (the
    norm of the whole gradient's difference over its norm)."""
    loss0, grads0, calls0 = runs[0]
    kernels, kernel_spread = {}, 0.0
    params = {}
    flat0 = torch.cat([g.float().reshape(-1) for g in grads0.values()])
    grad_spread = 0.0
    for loss, grads, calls in runs[1:]:
        if len(calls) != len(calls0):
            kernels["(call count)"] = kernels.get("(call count)", 0) + 1
        for (name, outs), (_, outs0) in zip(calls, calls0):
            bad = [(a, b) for a, b in zip(outs, outs0) if not same_bits(torch, a, b)]
            if bad or len(outs) != len(outs0):
                kernels[name] = kernels.get(name, 0) + 1
            for a, b in bad:
                scale = max(b.float().abs().max().item(), 1e-30)
                kernel_spread = max(kernel_spread,
                                    (a.float() - b.float()).abs().max().item() / scale)
        for k, g0 in grads0.items():
            if not same_bits(torch, grads[k], g0):
                rel = ((grads[k].float() - g0.float()).abs().max().item()
                       / max(g0.float().abs().max().item(), 1e-30))
                params[k] = max(params.get(k, 0.0), rel)
        flat = torch.cat([g.float().reshape(-1) for g in grads.values()])
        grad_spread = max(grad_spread, ((flat - flat0).norm() / flat0.norm()).item())
    return dict(loss_equal=all(same_bits(torch, r[0], loss0) for r in runs),
                kernel_calls=len(calls0), kernels_differing=kernels,
                kernel_spread=kernel_spread, params_differing=params,
                grad_spread=grad_spread)


def determinism_phase(torch, mods, dev, repeats: int = 2):
    """Every kernel the network runs, twice on the same inputs: the loss and
    backward of ``grad_check`` on each route and dtype, the allocator's free
    memory filled with NaN bytes before the first run and random bytes before
    the second. Fails on any kernel output whose bits differ; prints the
    spread of the network's gradient between the repeats, split into the
    port kernels' outputs and the rest (PyTorch's own ops)."""
    out = {}
    for attention in ("pallas_qkv", "pallas", "pallas_stream"):
        for dtype in ("float32", "bfloat16"):
            agent = grad_agent(torch, dev, attention, dtype)
            host = host_batch(torch, 8)
            runs = []
            for r in range(repeats):
                poison_allocator(torch, dev, (0xFF, None)[r % 2])
                runs.append(network_grads(torch, agent, host, mods))
            res = compare_repeats(torch, runs)
            out[f"{attention} {dtype}"] = {
                **{k: v for k, v in res.items() if k != "params_differing"},
                "params_differing": len(res["params_differing"]),
                "params": len(runs[0][1]),
                "largest_param_spreads": dict(sorted(
                    res["params_differing"].items(), key=lambda kv: -kv[1])[:4])}
            del agent, runs
    log("determinism", repeats=repeats, frames=8, cases=out)
    bad = {k: v["kernels_differing"] for k, v in out.items() if v["kernels_differing"]}
    check(not bad, f"kernel outputs differ between two runs on the same inputs: {bad}")
    return out


def _kernel_name(key: str) -> str:
    """A device kernel's function name without return type, namespaces of
    this file's kind, template arguments and parameters; K2's split-path
    product (``wg_gemm_kernel``) keeps its epilogue's name, which says which
    of its products it is."""
    name = key.replace("void ", "").replace("(anonymous namespace)::", "")
    base = name.split("<")[0].split("(")[0]
    if base == "wg_gemm_kernel" and (m := re.search(r"\b(Epi[A-Za-z0-9]+)", name)):
        return f"{base} {m.group(1)}"
    return base


def device_activity(prof, per: int):
    """What a ``torch.profiler`` trace ran on the card: ``(window ms, busy
    share of the window, {kernel: device ms})``, the times over ``per``; None
    when it recorded no device activity."""
    events = prof.events()
    # kernels, copies and fills, not the host ranges ("Optimizer.step#...",
    # the program's "eavit.*" spans) that the profiler mirrors onto the
    # card's timeline as annotations
    annotations = {e.name for e in events
                   if e.is_user_annotation and not str(e.device_type).endswith("CUDA")}
    on_card = [e for e in events if str(e.device_type).endswith("CUDA")
               and not e.is_user_annotation and e.name not in annotations]
    spans = sorted((e.time_range.start, e.time_range.end) for e in on_card)
    if not spans:
        return None
    busy, (cur_s, cur_e) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = spans[-1][1] - spans[0][0]
    by_kernel = {}
    for e in on_card:
        name = _kernel_name(e.name)
        by_kernel[name] = by_kernel.get(name, 0.0) + e.time_range.elapsed_us() / 1e3 / per
    return window / 1e3 / per, busy / window, by_kernel


def profile_minibatches(torch, agent, state, rollout, rng, steps: int = 8):
    """``torch.profiler`` over ``steps`` minibatch steps: the device time by
    kernel, and the share of the traced window in which the card ran something.
    Returns ``{}`` when the profiler recorded no device activity."""
    from torch.profiler import ProfilerActivity, profile

    cfg = agent.cfg
    _, batch, _ = agent.prepare_batch(state, rollout)
    n = batch.adv.shape[0]
    params = agent.trainable_parameters()
    idxs = agent._permutation(rng, n).reshape(cfg.mini_batch, n // cfg.mini_batch)[:steps]
    agent._minibatch_step(batch, idxs[0], rng, params)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for idx in idxs:
            agent._minibatch_step(batch, idx, rng, params)
        torch.cuda.synchronize()
    act = device_activity(prof, steps)
    if act is None:
        return {}
    window, share, by_kernel = act
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]
    out = dict(minibatch_steps=steps, window_ms_per_minibatch=window,
               window_busy_share=share, device_ms_per_minibatch=sum(by_kernel.values()),
               top_kernels_ms_per_minibatch=dict(top))
    log("profile", **out)
    return out


def profile_steps(torch, step, steps: int = 3):
    """``torch.profiler`` over ``steps`` calls of ``step``: ``(device ms a
    step, the card's busy share of the traced window)``, or ``(None, None)``
    when the profiler recorded no device activity."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    act = device_activity(prof, steps)
    if act is None:
        return None, None
    _, share, by_kernel = act
    return sum(by_kernel.values()), share


def profile_collect(torch, collector, env_state, rng):
    """``torch.profiler`` over one device-env ``collect``: its device time by
    kernel a step ({} when the profiler recorded no device activity). The
    device time over ``collect_s`` measured without the profiler is the
    card's busy share of a rollout."""
    from torch.profiler import ProfilerActivity, profile

    steps = collector.cfg.num_step
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        collector.collect(env_state, rng)
        torch.cuda.synchronize()
    act = device_activity(prof, steps)
    if act is None:
        return {}
    _, _, by_kernel = act
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    return dict(device_ms_per_step=sum(by_kernel.values()),
                top_kernels_ms_per_step=dict(top))


def backbone(cfg):
    """``(depth, dropout, patch size)`` of the backbone ``cfg`` names."""
    from eavit_tpu_torch.config import ViTImplementation

    if cfg.vit_implementation_type == ViTImplementation.HG:
        h = cfg.vit_hg
        return h.num_hidden_layers, h.hidden_dropout_prob, h.patch_size
    return cfg.vit.depth, cfg.vit.dropout, cfg.vit.patch_size


def training_path(torch, mods, dev, shared: bool, epochs: int, updates: int,
                  workdir: str, attention: str = "pallas_qkv", vit=None,
                  pieces: bool = False, base_cfg=None):
    """``train.train`` at full width, then what its checkpoint holds; with
    ``pieces`` one more iteration timed in pieces, and ``evaluate``. ``vit``
    replaces fields of the ViT configuration (dropout, patch size);
    ``base_cfg`` stands in for the flagship's configuration (the HF
    flavour's)."""
    import dataclasses

    from eavit_tpu_torch import train as port_train
    from eavit_tpu_torch.eval import evaluate
    from eavit_tpu_torch.envs.builders import make_vector_env
    from eavit_tpu_torch.models.layers import Rng
    from eavit_tpu_torch.rl.agent import RNDAgent
    from eavit_tpu_torch.rl.device_rollout import DeviceRolloutCollector
    from eavit_tpu_torch.utils.checkpoint import load_checkpoint

    mode = "shared" if shared else "stacked"
    cfg = (base_cfg or flagship_cfg(shared, attention)).replace(
        epoch=epochs, obs_norm_step=1, save_ckpt_every=updates, log_name=f"smoke_{mode}",
        save_model_path=os.path.join(workdir, "ckpt"))
    if vit:
        cfg = cfg.replace(vit=dataclasses.replace(cfg.vit, **vit))
    depth, dropout, patch = backbone(cfg)
    what = f"{mode}, {attention}, dropout {dropout}, patch {patch}, depth {depth}"
    frames = cfg.num_step * cfg.num_env_per_process
    per_update = depth * epochs * cfg.mini_batch
    per_rollout = depth * (cfg.num_step + 1)
    attn_fwd, attn_bwd = attention_kernels(attention, dropout > 0)
    fwd, bwd = (attn_fwd, "fused_ffn_fwd"), (*attn_bwd, "fused_ffn_bwd")

    torch.cuda.synchronize()
    _reset(mods)
    t0 = time.perf_counter()
    metrics = port_train.train(cfg, total_updates=updates,
                               log_dir=os.path.join(workdir, "logs"))  # CUDA by default
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    counts = _counts(mods)  # the main path ends here

    expect = {**{k: updates * (per_rollout + per_update) for k in fwd},
              **{k: updates * per_update for k in bwd}}
    finite = all(v == v and abs(v) != float("inf") for v in metrics.values())
    parts = sum(metrics[k] for k in LOSS_PARTS)
    log("train", mode=mode, attention=attention, dropout=dropout, patch=patch, depth=depth,
        updates=updates, epochs=epochs, train_s=train_s,
        frames_per_s=updates * frames / train_s, launches=counts,
        expected_launches=expect, finite=finite, metrics=metrics, loss_parts_sum=parts)
    check_counts(counts, expect, f"{what}: train")
    check(finite, f"{what}: finite metrics")
    check(abs(metrics["train/loss"] - parts) <= 1e-4 * max(1.0, abs(parts)),
          f"{what}: train/loss {metrics['train/loss']} != sum of parts {parts}")

    # the checkpoint, loaded into a fresh agent
    path = os.path.join(cfg.save_model_path, cfg.log_name)
    with open(path + ".json") as fh:
        meta = json.load(fh)
    check(meta["global_update"] == updates and meta["global_step"] == updates * frames,
          f"{mode}: sidecar counters {meta['global_update']}, {meta['global_step']}")
    agent = RNDAgent(cfg, 5)
    agent.init_state(cfg.seed)  # the weights train() started from
    start = {k: copy.deepcopy(m.state_dict()) for k, m in agent._modules().items()}
    state, _ = load_checkpoint(path, agent)
    check(state.global_step == updates * frames and state.global_update == updates,
          f"{mode}: loaded counters")
    moved = {k: sum(not torch.equal(v, start[k][n]) for n, v in m.state_dict().items())
             for k, m in agent._modules().items()}
    total = {k: len(v) for k, v in start.items()}
    log("checkpoint", mode=mode, path=path + ".pt", bytes=os.path.getsize(path + ".pt"),
        tensors_moved=moved, tensors=total, global_step=state.global_step)
    check(moved["policy"] == total["policy"] and moved["rnd_pred"] == total["rnd_pred"],
          f"{mode}: every policy and rnd_pred tensor moved ({moved} of {total})")
    check(moved["rnd_target"] == 0, f"{mode}: rnd_target did not move")
    if not pieces:
        return counts, None

    # one more iteration in pieces, for the split of the time, with the
    # collector train runs
    env = make_vector_env(cfg)
    collector = DeviceRolloutCollector(cfg, agent, env)
    rng = Rng(SEED + 3, agent.device)
    states = env.reset()
    _reset(mods)
    t0 = time.perf_counter()
    rollout, states = collector.collect(states, rng)
    torch.cuda.synchronize()
    collect_s = time.perf_counter() - t0
    collect_counts = _counts(mods)
    t0 = time.perf_counter()
    agent.prepare_batch(state, rollout)
    torch.cuda.synchronize()
    prepare_s = time.perf_counter() - t0
    _reset(mods)
    torch.cuda.reset_peak_memory_stats()
    base_gb = torch.cuda.memory_allocated() / 2 ** 30
    t0 = time.perf_counter()
    state, m2 = agent.update(state, rollout, rng)
    loss = float(m2["train/loss"])
    torch.cuda.synchronize()
    update_s = time.perf_counter() - t0
    update_counts = _counts(mods)
    update_peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    check_counts(collect_counts, {k: per_rollout for k in fwd}, f"{what}: collect")
    check_counts(update_counts, {k: per_update for k in fwd + bwd}, f"{what}: one update")
    check(loss == loss, "finite loss in the timed update")
    timing = dict(collect_s=collect_s, prepare_batch_s=prepare_s, update_s=update_s,
                  sgd_s=update_s - prepare_s, iteration_s=collect_s + update_s,
                  frames_per_s=frames / (collect_s + update_s),
                  launches_per_update=update_counts, launches_per_rollout=collect_counts,
                  update_peak_memory_gb=update_peak_gb,
                  update_peak_above_start_gb=update_peak_gb - base_gb)
    # the card's busy share of an update: the kernels' own durations under the
    # profiler over the step time measured without it (tracing slows the host,
    # so the profiled window itself is longer than a step is)
    prof = profile_minibatches(torch, agent, state, rollout, rng)
    step_ms = (update_s - prepare_s) / (epochs * cfg.mini_batch) * 1e3
    timing["minibatch_step_ms"] = step_ms
    timing["device_busy_share"] = (prof["device_ms_per_minibatch"] / step_ms
                                   if prof else None)  # None: not measured

    # a short greedy episode from the checkpoint: deterministic forwards, so
    # the attention runs without dropout (K4f on the pallas route)
    _reset(mods)
    t0 = time.perf_counter()
    out = evaluate(cfg.replace(load_model_path=path, max_step_per_episode=96,
                               log_name=f"smoke_{mode}"), num_episodes=1, greedy=True,
                   log_dir=os.path.join(workdir, "logs"))
    eval_counts = _counts(mods)
    per_step = depth * out["intrinsic_trace_len"]
    log("eval", attention=attention, seconds=time.perf_counter() - t0,
        launches=eval_counts, **out)
    check(out["episodes"] == 1 and out["intrinsic_trace_len"] == 96
          and out["mean_return"] == out["mean_return"], f"evaluate returned {out}")
    check_counts(eval_counts, {attention_kernels(attention, False)[0]: per_step,
                               "fused_ffn_fwd": per_step}, f"{what}: evaluate")
    return counts, timing


# ---------------------------------------------------------------------------
# the zero-host path: EnvType = synthetic_device
# ---------------------------------------------------------------------------

DEVICE_ENV_UPDATES = 2  # iterations of the flagship device-env run (its config runs forever)
REPO_ROOT = os.path.dirname(os.path.abspath(__file__))


def _env_on(state, device):
    return type(state)(*(t.to(device) for t in state))


def device_env_phase(torch, mods, dev, workdir: str, host_timing):
    """``train.train`` on ``configs/synthetic_device_flagship.conf`` at full
    width (64 envs x 128 steps, dim 256, depth 3, pallas_qkv, fused FFN, bf16,
    dropout 0.1), cut to ``ObsNormStep = 1`` and ``DEVICE_ENV_UPDATES``
    iterations: launch counts (the warm-up's policy rollout included), finite
    metrics, and a resume from its checkpoint that brings back the env's
    ever-visited rooms. Then one iteration in pieces with the agent and
    collector built as ``train`` builds them: ``collect`` under
    ``torch.cuda.set_sync_debug_mode`` (every host sync counted, none
    allowed), the rollout replayed bit for bit on the port's own device env
    stepped on the CPU with the card's actions, ``collect_s`` and
    ``update_s`` beside the host-env flagship iteration of this call
    (``host_timing``). Last, one iteration of ``configs/maze_exploration.conf``
    (16 envs x 32 steps; the xla route without the fused FFN: no kernel)."""
    from eavit_tpu_torch import train as port_train
    from eavit_tpu_torch.config import EnvType, load_config
    from eavit_tpu_torch.envs.device_env import device_env_step, make_device_env
    from eavit_tpu_torch.models.layers import Rng
    from eavit_tpu_torch.rl.agent import RNDAgent
    from eavit_tpu_torch.rl.scan_rollout import ScanRolloutCollector
    from eavit_tpu_torch.utils.checkpoint import load_checkpoint

    cuts = dict(obs_norm_step=1, updates=DEVICE_ENV_UPDATES)
    cfg = load_config(os.path.join(REPO_ROOT, "configs", "synthetic_device_flagship.conf"))
    check(cfg.env_type == EnvType.SYNTHETIC_DEVICE and cfg.num_env_per_process == NUM_ENVS
          and cfg.num_step == NUM_STEP and cfg.vit.dim == 256 and cfg.vit.depth == DEPTH
          and cfg.vit.dropout == 0.1 and cfg.attention_impl == "pallas_qkv" and cfg.fused_ffn
          and cfg.compute_dtype == "bfloat16" and cfg.shared_patch_stream,
          "synthetic_device_flagship.conf is the flagship at full width")
    cfg = cfg.replace(obs_norm_step=cuts["obs_norm_step"], save_ckpt_every=cuts["updates"],
                      log_name="smoke_device", save_model_path=os.path.join(workdir, "ckpt"))
    frames = cfg.num_step * cfg.num_env_per_process
    per_rollout = cfg.vit.depth * (cfg.num_step + 1)
    per_update = cfg.vit.depth * cfg.epoch * cfg.mini_batch
    updates = cuts["updates"]

    torch.cuda.synchronize()
    _reset(mods)
    t0 = time.perf_counter()
    metrics = port_train.train(cfg, total_updates=updates,
                               log_dir=os.path.join(workdir, "logs"))  # CUDA by default
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    counts = _counts(mods)  # the device-env path ends here
    # the warm-up's policy rollout, then per iteration a rollout and an update
    fwd = (updates + 1) * per_rollout + updates * per_update
    expect = {"flash_qkv_fwd": fwd, "fused_ffn_fwd": fwd,
              "flash_qkv_bwd": updates * per_update, "fused_ffn_bwd": updates * per_update}
    check_counts(counts, expect, "device env: train")
    finite = all(v == v and abs(v) != float("inf") for v in metrics.values())
    check(finite, "device env: finite metrics")
    env_names = ("data/num_episodes", "data/mean_undiscounted_episode_return",
                 "data/mean_number_of_visited_rooms", "data/mean_rooms_discovered",
                 "data/total_rooms_discovered")
    check(all(k in metrics for k in env_names), f"device env metrics: {sorted(metrics)}")

    # resume: the sidecar's ever-visited rooms come back
    path = os.path.join(cfg.save_model_path, cfg.log_name)
    with open(path + ".json") as fh:
        meta = json.load(fh)
    params, fresh = make_device_env(
        cfg.num_env_per_process, seed=cfg.seed, grid=cfg.synthetic_grid,
        stack=cfg.state_stack_size, height=cfg.pre_proc_height, width=cfg.pre_proc_width,
        max_episode_steps=cfg.max_step_per_episode, maze=cfg.synthetic_maze,
        texture=cfg.synthetic_texture, shared_world=cfg.synthetic_shared_world,
        variants=cfg.synthetic_variants, sparse_goal=cfg.synthetic_sparse_goal,
        goal_depth=cfg.synthetic_goal_depth, device=dev)
    restored = port_train._restore_device_env_stats(fresh, meta)
    saved_rooms = int(restored.ever_visited.sum())
    resumed = port_train.train(cfg.replace(load_model=True, load_model_path=path,
                                           log_name="smoke_device_resumed"),
                               total_updates=updates + 1, log_dir=os.path.join(workdir, "logs"))
    resumed_ok = (saved_rooms > cfg.num_env_per_process
                  and resumed["data/mean_rooms_discovered"]
                  >= saved_rooms / cfg.num_env_per_process)
    check(resumed_ok, f"device env: resume kept {saved_rooms} rooms, then "
          f"{resumed['data/mean_rooms_discovered']} per env")

    # one iteration in pieces, as train builds it, from the checkpoint
    agent = RNDAgent(cfg, 5)
    agent.init_state(cfg.seed)
    state, _ = load_checkpoint(path, agent)
    collector = ScanRolloutCollector(cfg, agent, params)
    rng = Rng(SEED + 3, agent.device)
    env_state = restored
    rollout, env_state, _ = collector.collect(env_state, rng)  # warm: allocator, cuDNN
    (rollout, env_state, _), syncs = host_syncs(
        torch, lambda: collector.collect(env_state, rng))
    torch.cuda.set_sync_debug_mode("error")
    try:
        collector.collect(env_state, rng)
        raised = None
    except RuntimeError as e:
        raised = str(e).split("\n")[0]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    start = _env_on(env_state, "cpu")
    torch.cuda.synchronize()
    _reset(mods)
    t0 = time.perf_counter()
    rollout, end, env_metrics = collector.collect(env_state, rng)
    torch.cuda.synchronize()
    collect_s = time.perf_counter() - t0
    collect_counts = _counts(mods)
    _reset(mods)
    t0 = time.perf_counter()
    state, m2 = agent.update(state, rollout, rng)
    loss = float(m2["train/loss"])
    torch.cuda.synchronize()
    update_s = time.perf_counter() - t0
    update_counts = _counts(mods)
    # the card's busy share of a rollout: its device time under the profiler
    # over collect_s without it
    prof = profile_collect(torch, collector, end, rng)
    busy = (prof["device_ms_per_step"] * cfg.num_step / (collect_s * 1e3) if prof
            else None)  # None: not measured
    check_counts(collect_counts, {"flash_qkv_fwd": per_rollout, "fused_ffn_fwd": per_rollout},
                 "device env: collect")
    check_counts(update_counts, {k: per_update for k in expect}, "device env: one update")
    check(loss == loss, "device env: finite loss in the timed update")

    # the rollout against the port's device env stepped on the CPU with the
    # card's actions: states, rewards, dones and next_obs bit for bit
    cpu_params = type(params)(*(t.cpu() if isinstance(t, torch.Tensor) else t for t in params))
    cpu_state, mismatch = start, []
    ro = type(rollout)(*(t.cpu() for t in rollout))
    for t in range(cfg.num_step):
        if not torch.equal(ro.states[t], cpu_state.stack):
            mismatch.append(f"states {t}")
        cpu_state, r, d, _ = device_env_step(cpu_params, cpu_state, ro.actions[t])
        for name, a, b in (("rewards", ro.rewards[t], r), ("dones", ro.dones[t], d),
                           ("next_obs", ro.next_obs[t], cpu_state.stack[:, -1:])):
            if not torch.equal(a, b):
                mismatch.append(f"{name} {t}")
    end_cpu = _env_on(end, "cpu")
    mismatch += [f"final {f}" for f in end._fields
                 if not torch.equal(getattr(end_cpu, f), getattr(cpu_state, f))]
    card = gpu_name_power()
    log("device_env", config="configs/synthetic_device_flagship.conf", cuts=cuts,
        envs=cfg.num_env_per_process, steps=cfg.num_step, frames=frames,
        train_s=train_s, train_launches=counts, expected_train_launches=expect,
        finite=finite, metrics={k: metrics[k] for k in sorted(metrics)},
        resume_saved_rooms=saved_rooms,
        resume_mean_rooms_discovered=resumed["data/mean_rooms_discovered"],
        collect_s=collect_s, update_s=update_s,
        iteration_s=collect_s + update_s, frames_per_s=frames / (collect_s + update_s),
        step_ms=collect_s / (cfg.num_step + 1) * 1e3, collect_profile=prof,
        collect_device_busy_share=busy,
        launches_per_rollout=collect_counts, launches_per_update=update_counts,
        host_syncs_in_collect=len(syncs), host_syncs=syncs[:5], sync_error=raised,
        replay_mismatches=mismatch[:10], replay_equal=not mismatch,
        rollout_episodes=float(env_metrics["data/num_episodes"]),
        host_env=dict(collect_s=host_timing["collect_s"], update_s=host_timing["update_s"],
                      frames_per_s=host_timing["frames_per_s"]),
        card=card)
    check(not syncs and raised is None, f"device env: host syncs in collect: {syncs} {raised}")
    check(not mismatch, f"device env: rollout differs from the CPU replay: {mismatch[:10]}")

    # the maze exploration config, cut to 16 envs x 32 steps, one iteration
    mcfg = load_config(os.path.join(REPO_ROOT, "configs", "maze_exploration.conf")).replace(
        num_env_per_process=16, num_step=32, obs_norm_step=1, log_name="smoke_maze",
        save_model_path=os.path.join(workdir, "maze_ckpt"))
    _reset(mods)
    t0 = time.perf_counter()
    mm = port_train.train(mcfg, total_updates=1, log_dir=os.path.join(workdir, "logs"))
    torch.cuda.synchronize()
    maze_counts = _counts(mods)
    maze_finite = all(v == v and abs(v) != float("inf") for v in mm.values())
    log("device_env_maze", config="configs/maze_exploration.conf",
        cuts=dict(envs=16, steps=32, obs_norm_step=1, updates=1),
        seconds=time.perf_counter() - t0, launches=maze_counts, finite=maze_finite,
        total_rooms_discovered=mm["data/total_rooms_discovered"],
        mean_rooms_discovered=mm["data/mean_rooms_discovered"], loss=mm["train/loss"])
    check_counts(maze_counts, {}, "maze (xla route, no fused FFN)")
    check(maze_finite, "maze: finite metrics")
    return counts


# ---------------------------------------------------------------------------
# continuous actions, NoisyNet and modified_RND (ROADMAP.md Queue 1, item 5)
# ---------------------------------------------------------------------------

# the criteria of the network's gradient against its CPU copy (ROADMAP.md
# Queue 2, the precision contract of float32 K2): 1.2e-6 was read on the
# original_RND flagship, whose RND convolutions carry much of the gradient's
# norm. Float32 K2 keeps about 2^-16 a product (three bf16 terms), and on a
# network without the conv RND its share of the gradient is larger: there
# the float32 criterion holds with K2 on its plain version (every other
# kernel on the card), and the whole network with K2's kernels is held to
# the products' own precision, 2^-16
GRAD_CRITERIA = {"float32": 1.2e-6, "bfloat16": 5.3e-4}
K2_PRODUCT_PRECISION = 2.0 ** -16


class ContinuousSmokeEnv:
    """A vectorised continuous-action env with the interface the port's
    classic-control fleet gives Pendulum-v1 (``envs/pool.py``), and no
    gymnasium: Pendulum's dynamics (g 10, m 1, l 1, dt 0.05, speed capped at
    8), one action in [-1, 1] clipped and scaled to a torque in [-2, 2] as
    ``ActionScaleWrapper`` does, the reward scaled by 1/16 as
    ``pendulum_continuous.conf``'s ``RewardScale``, episodes cut at 200
    steps with auto-reset, and 84 x 84 uint8 frames drawn from the angle
    (a rod at one of 360 angles, looked up), stacked 4 deep. Modelled on
    ``tests/test_continuous.py``'s ``ContinuousSyntheticEnv``."""

    def __init__(self, num_envs: int, seed: int = 0, stack: int = 4, size: int = 84,
                 max_steps: int = 200):
        import numpy as np

        self.np, self.num_envs, self.max_steps = np, num_envs, max_steps
        self.action_space_n, self.action_dim = None, 1
        self.rng = np.random.default_rng(seed)
        grid = np.linspace(-1.0, 1.0, size, dtype=np.float32)
        yy, xx = np.meshgrid(grid, grid, indexing="ij")
        angles = np.arange(360) * (2 * np.pi / 360)
        c, s = np.cos(angles)[:, None, None], np.sin(angles)[:, None, None]
        # a bright rod from the centre along the angle, on a dim ramp
        along, across = xx * s - yy * c, xx * c + yy * s
        rod = (np.abs(across) < 0.08) & (along > 0.0) & (along < 0.8)
        self.table = np.where(rod, 255, 40 + 30 * (yy + 1)).astype(np.uint8)
        self.theta = np.zeros(num_envs, np.float32)
        self.omega = np.zeros(num_envs, np.float32)
        self.steps = np.zeros(num_envs, np.int64)
        self.returns = np.zeros(num_envs, np.float64)
        self.stack = np.zeros((num_envs, stack, size, size), np.uint8)
        self.torque_range = [np.inf, -np.inf]  # of the torques the env applied

    def _frames(self, idx):
        bins = (self.theta[idx] * (360 / (2 * self.np.pi))).round().astype(self.np.int64)
        return self.table[bins % 360]

    def _reset_envs(self, idx):
        self.theta[idx] = self.rng.uniform(-self.np.pi, self.np.pi, len(idx))
        self.omega[idx] = self.rng.uniform(-1.0, 1.0, len(idx))
        self.steps[idx] = 0
        self.returns[idx] = 0.0
        self.stack[idx] = self._frames(idx)[:, None]

    def reset(self):
        self._reset_envs(self.np.arange(self.num_envs))
        return self.stack.copy()

    def sample_random_actions(self, rng):
        return rng.uniform(-1.0, 1.0, (self.num_envs, 1)).astype(self.np.float32)

    def step(self, actions):
        np = self.np
        u = 2.0 * np.clip(np.asarray(actions, np.float32).reshape(self.num_envs), -1.0, 1.0)
        self.torque_range = [min(self.torque_range[0], float(u.min())),
                             max(self.torque_range[1], float(u.max()))]
        th = ((self.theta + np.pi) % (2 * np.pi)) - np.pi
        reward = -(th ** 2 + 0.1 * self.omega ** 2 + 0.001 * u ** 2) / 16.0
        self.omega = np.clip(self.omega + (15.0 * np.sin(self.theta) + 3.0 * u) * 0.05,
                             -8.0, 8.0).astype(np.float32)
        self.theta = (self.theta + self.omega * 0.05).astype(np.float32)
        self.steps += 1
        self.returns += reward
        all_envs = np.arange(self.num_envs)
        self.stack[:, :-1] = self.stack[:, 1:]
        self.stack[:, -1] = self._frames(all_envs)
        truns = self.steps >= self.max_steps
        dones = np.zeros(self.num_envs, np.bool_)
        infos = [{"episode": {"r": float(self.returns[i]), "l": int(self.steps[i])}}
                 if truns[i] else {} for i in range(self.num_envs)]
        if truns.any():
            self._reset_envs(np.nonzero(truns)[0])
        return self.stack.copy(), reward.astype(np.float32), dones, truns, infos

    def close(self):
        pass


def freeze_noise(torch, agents, seed: int) -> None:
    """Give every NoisyLinear of the agents' networks one eps, drawn once on
    the CPU from ``seed``: the same noise in each copy (the card's generator
    draws other numbers than the CPU's)."""
    from eavit_tpu_torch.models.layers import NoisyLinear

    gen = torch.Generator().manual_seed(seed)
    heads = [[m for m in a.network.modules() if isinstance(m, NoisyLinear)] for a in agents]
    for layers in zip(*heads):
        std = layers[0].sigma0 / layers[0].in_features ** 0.5
        eps = (torch.randn(layers[0].in_features, generator=gen) * std,
               torch.randn(layers[0].out_features, generator=gen) * std)
        for m in layers:
            m.sample_noise = lambda rng, device, eps=eps: tuple(e.to(device) for e in eps)


def freeze_views(torch, agents, n: int, seed: int) -> None:
    """Give the SSL heads of the agents one set of augment parameters for
    their two views of ``n`` frames, drawn once on the CPU from ``seed`` (the
    card's generator draws other numbers than the CPU's). No-op without SSL."""
    from eavit_tpu_torch.ops.augment import AugmentParams

    if agents[0].ssl is None:
        return
    cfg = agents[0].cfg
    views = agents[0].ssl.draw(torch.Generator().manual_seed(seed), n, cfg.pre_proc_height,
                               cfg.pre_proc_width, "cpu")
    for a in agents:
        mine = tuple(AugmentParams(*(t.to(a.device) for t in v)) for v in views)
        a._augment_params = lambda rng, m, mine=mine: mine


class K2Plain:
    """While open, the fused FFN's wrappers run their plain versions, on the
    card too (a diagnosis of the gradient check, never the main path)."""

    def __init__(self, ff):
        self.ff, self.saved = ff, (ff.fused_ffn_fwd, ff.fused_ffn_bwd)

    def __enter__(self):
        self.ff.fused_ffn_fwd = self.ff.fused_ffn_fwd_plain
        self.ff.fused_ffn_bwd = self.ff.fused_ffn_bwd_plain
        return self

    def __exit__(self, *exc):
        self.ff.fused_ffn_fwd, self.ff.fused_ffn_bwd = self.saved


class SSLEmbeddings:
    """While open, the SSL heads' backbone embeddings (``models/ssl.embed``)
    are recorded into ``record`` as ``[value, gradient]`` (the gradient of
    the loss at the embedding, on the host; None where none flows, as into
    BYOL's target), or, given ``inject`` (such records, in call order),
    replaced in value by those. With ``cotangents`` the backbone below an
    embedding is also handed the recorded gradient in place of the one the
    heads compute, so the heads drop out of the backbone's gradient."""

    def __init__(self, record=None, inject=None, cotangents: bool = False):
        from eavit_tpu_torch.models import ssl

        self.ssl, self.embed = ssl, ssl.embed
        self.record, self.inject = record, None if inject is None else iter(inject)
        self.cotangents = cotangents

    def __enter__(self):
        import torch

        class Handed(torch.autograd.Function):
            @staticmethod
            def forward(ctx, e, value, grad):
                ctx.grad = grad
                return value.clone()

            @staticmethod
            def backward(ctx, _):
                return ctx.grad, None, None

        def embed(backbone, imgs):
            e = self.embed(backbone, imgs)
            if self.record is not None:
                slot = [e.detach().cpu(), None]
                self.record.append(slot)
                if e.requires_grad:
                    e.register_hook(lambda g, slot=slot: slot.__setitem__(1, g.detach().cpu()))
            if self.inject is not None:
                value, grad = next(self.inject)
                value = value.to(e.device)
                if self.cotangents and grad is not None and e.requires_grad:
                    e = Handed.apply(e, value, grad.to(e.device))
                else:
                    e = e + (value - e).detach()
            return e

        self.ssl.embed = embed
        return self

    def __exit__(self, *exc):
        self.ssl.embed = self.embed


def _rel(torch, a, b) -> float:
    return ((a - b).norm() / b.norm()).item()


# the precision of a bf16 operand (its unit roundoff): the criterion of the
# bf16 network's gradient under an SSL head, where PR 12's 5.3e-4 does not
# carry over. That number was read where the float32 conv RND holds 96% of
# the gradient's norm; with frames that differ the bf16 policy heads and
# backbone carry more of it
BF16_ROUNDOFF = 2.0 ** -9


def noisy_grad_check(torch, dev, cfg, output_size: int, action_space, host, what: str,
                     criteria=None, bf16_reference=None):
    """The loss and gradient of the whole network (and of ``rnd_pred`` and
    the SSL heads, if any) on the frames ``host``, on the card against a copy
    on the CPU, both from ``SEED`` at dropout 0 with one NoisyLinear noise and
    one set of SSL augment parameters given to both. bf16: within
    ``criteria`` (``GRAD_CRITERIA`` unless given). Float32: within
    ``criteria`` with K2 on its plain version (``K2Plain``), and within
    ``K2_PRODUCT_PRECISION`` with every kernel (see the criteria's comment).

    With an SSL head the joint gradient is not held: it is ill-conditioned
    in the embeddings (an embedding that moves by 1.4e-6 moves Barlow
    Twins' gradient by 1e-3), so it is logged (``grad_rel_err``). Held
    instead, each to the criterion: the loss; the SSL embeddings, the
    kernels' output at rate 0 (``embedding_rel_err``); and the gradient of
    the network and the RND predictor with the CPU copy handed the card's
    embeddings and their gradients (``network_grad_rel_err_given_card_ssl``),
    which compares the kernels' forwards and backwards on the same inputs
    with the heads out of the way; in bf16 that gradient is held to
    ``BF16_ROUNDOFF``. Logged
    beside them: the gradients at the embeddings (``embedding_grad_rel_err``)
    and the heads' own gradients given the card's embeddings
    (``heads_grad_rel_err_given_card_embedding``: torch's float32 products,
    up to 8,192 wide, on the card's BLAS against the CPU's).

    With ``bf16_reference`` the bf16 gradient is also held against a float32
    copy on the CPU: its distance from it (``grad_rel_err_vs_cpu_float32``)
    at most ``bf16_reference`` times the CPU bf16 copy's
    (``cpu_grad_rel_err_vs_cpu_float32``)."""
    import dataclasses

    from eavit_tpu_torch.ops import fused_ffn
    from eavit_tpu_torch.rl.agent import RNDAgent

    def flat(g, keys):
        return torch.cat([g[k].float().reshape(-1).cpu() for k in keys])

    def rel_errs(dtype, reference=False):
        c = cfg.replace(compute_dtype=dtype, update_proportion=1.0,
                        vit=dataclasses.replace(cfg.vit, dropout=0.0, emb_dropout=0.0),
                        vit_hg=dataclasses.replace(cfg.vit_hg, hidden_dropout_prob=0.0))
        agents = [RNDAgent(c, output_size, action_space, device=where) for where in (dev, "cpu")]
        if reference:  # the float32 copy on the CPU
            agents.append(RNDAgent(c.replace(compute_dtype="float32"), output_size,
                                   action_space, device="cpu"))
        for a in agents:
            a.init_state(SEED)
        freeze_noise(torch, agents, SEED + 11)
        freeze_views(torch, agents, host["states"].shape[0], SEED + 12)
        embs_d, embs_c = [], []
        with SSLEmbeddings(record=embs_d):
            loss_d, g_d, _ = network_grads(torch, agents[0], host, ())
        with SSLEmbeddings(record=embs_c):
            loss_c, g_c, _ = network_grads(torch, agents[1], host, ())
        out = dict(loss_cuda=float(loss_d), loss_cpu=float(loss_c),
                   loss_rel_err=abs(float(loss_d) - float(loss_c)) / max(1.0, abs(float(loss_c))),
                   grad_rel_err=_rel(torch, flat(g_d, g_c), flat(g_c, g_c)),
                   grad_elements=sum(t.numel() for t in g_c.values()))
        if reference:
            _, g_r, _ = network_grads(torch, agents[2], host, ())
            out.update(grad_rel_err_vs_cpu_float32=_rel(torch, flat(g_d, g_r), flat(g_r, g_r)),
                       cpu_grad_rel_err_vs_cpu_float32=_rel(torch, flat(g_c, g_r),
                                                            flat(g_r, g_r)))
        if embs_d:
            with SSLEmbeddings(inject=embs_d, cotangents=True):
                _, g_k, _ = network_grads(torch, agents[1], host, ())
            net = [k for k in g_c if not k.startswith("ssl.")]
            heads = [k for k in g_c if k.startswith("ssl.")]
            out.update(
                embedding_rel_err=max(_rel(torch, a[0], b[0]) for a, b in zip(embs_d, embs_c)),
                embedding_grad_rel_err=max(_rel(torch, a[1], b[1]) for a, b in zip(embs_d, embs_c)
                                           if a[1] is not None),
                network_grad_rel_err_given_card_ssl=_rel(torch, flat(g_d, net), flat(g_k, net)),
                heads_grad_rel_err_given_card_embedding=_rel(torch, flat(g_d, heads),
                                                             flat(g_k, heads)))
        return out

    def judge(res, base, label):
        ssl = "embedding_rel_err" in res
        grad, crit = (("network_grad_rel_err_given_card_ssl",
                       BF16_ROUNDOFF if label == "bfloat16" else base) if ssl
                      else ("grad_rel_err", base))
        res.update(criterion=base, held=grad, held_criterion=crit)
        check(res[grad] <= crit and res["loss_rel_err"] <= base
              and res.get("embedding_rel_err", 0.0) <= base,
              f"{what}: gradient on the card vs the CPU copy, {label}: {res}")

    out = {}
    for dtype, crit in (criteria or GRAD_CRITERIA).items():
        res = rel_errs(dtype, reference=bf16_reference is not None and dtype == "bfloat16")
        if dtype == "float32":
            with K2Plain(fused_ffn):
                plain = rel_errs(dtype)
            judge(plain, crit, "float32, K2 plain")
            res["k2_plain"] = plain
        judge(res, crit if dtype == "bfloat16" else K2_PRODUCT_PRECISION, dtype)
        if "grad_rel_err_vs_cpu_float32" in res:
            res["reference_factor"] = bf16_reference
            check(res["grad_rel_err_vs_cpu_float32"]
                  <= bf16_reference * res["cpu_grad_rel_err_vs_cpu_float32"],
                  f"{what}: bf16 gradient on the card vs the CPU's float32, against the "
                  f"CPU's bf16: {res}")
        out[dtype] = res
    return out


def host_syncs(torch, fn):
    """``fn()`` under ``torch.cuda.set_sync_debug_mode("warn")``: its result
    and the first lines of the host-sync warnings it raised."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    return out, [str(w.message).split("\n")[0] for w in caught
                 if "called a synchronizing" in str(w.message)]


def item5_kernel_shapes(torch, fq, ff, kp, dev, chunk: int):
    """K1f and K2f at the shapes item 5 adds: the ``modified_RND`` next-obs
    pass (``chunk`` frames a backbone call, rate 0) and the 1,024-frame
    minibatch of ``pendulum_continuous.conf`` (8,192 / ``MiniBatch`` 8, rate
    0.1), each held to its plain version and timed (``k1f_rows``,
    ``k2f_rows``)."""
    rows = {}
    for use, frames, rate in (("next_obs", chunk, 0.0), ("train_mb1024", 1024, 0.1)):
        rows[("flash_qkv_fwd", use)] = k1f_rows(torch, fq, dev, use, frames, 198, 2,
                                                (rate,))[("flash_qkv_fwd", use, 198, rate)]
        rows[("fused_ffn_fwd", use)] = k2f_rows(
            torch, ff, kp, dev, frames * 198, (torch.float32,),
            (rate,))[("fused_ffn_fwd", frames * 198, "float32", rate)]
    return rows


def continuous_phase(torch, mods, dev):
    """``configs/pendulum_continuous.conf`` with ``UseNoisyNet = True`` at full
    width (dim 256, depth 3, bf16, pallas_qkv, fused FFN, dropout 0.1) on
    ``ContinuousSmokeEnv``, 64 envs x 128 steps: the obs-norm warm-up (none
    under PPO), ``DeviceRolloutCollector.collect`` (serial, as ``train``
    runs it) and one ``update`` (4 epochs x 8
    minibatches of 1,024 frames), with their launch counts; the actions
    finite and the policy's mean in [-1, 1]; ``log_std`` after the update;
    the gradient on 8 frames against the CPU copy (``noisy_grad_check``)."""
    import numpy as np

    from eavit_tpu_torch.config import TrainMethod, load_config
    from eavit_tpu_torch.models.layers import Rng
    from eavit_tpu_torch.models.policy import ActionSpaceType
    from eavit_tpu_torch.rl.agent import RNDAgent
    from eavit_tpu_torch.rl.device_rollout import DeviceRolloutCollector

    cfg = load_config(os.path.join(REPO_ROOT, "configs", "pendulum_continuous.conf"))
    check(cfg.vit.dim == 256 and cfg.vit.depth == DEPTH and cfg.vit.dropout == 0.1
          and cfg.attention_impl == "pallas_qkv" and cfg.fused_ffn
          and cfg.compute_dtype == "bfloat16" and cfg.shared_patch_stream
          and cfg.train_method == TrainMethod.PPO and cfg.num_env_per_process == NUM_ENVS
          and cfg.num_step == NUM_STEP and (cfg.epoch, cfg.mini_batch) == (4, 8),
          "pendulum_continuous.conf at full width")
    cfg = cfg.replace(use_noisy_net=True, seed=SEED)
    env = ContinuousSmokeEnv(cfg.num_env_per_process, seed=SEED)
    agent = RNDAgent(cfg, env.action_dim, ActionSpaceType.CONTINUOUS)  # CUDA by default
    check(agent.device.type == "cuda", "continuous agent on CUDA")
    state = agent.init_state(SEED)
    rng = Rng(SEED + 1, agent.device)
    collector = DeviceRolloutCollector(cfg, agent, env)
    check(not collector.pipelined, "continuous: the serial device collector")
    states = env.reset()
    state, states = collector.warmup_obs_rms(state, states, rng)
    frames = cfg.num_step * cfg.num_env_per_process
    per_rollout = cfg.vit.depth * (cfg.num_step + 1)
    per_update = cfg.vit.depth * cfg.epoch * cfg.mini_batch

    torch.cuda.synchronize()
    _reset(mods)
    t0 = time.perf_counter()
    rollout, states = collector.collect(states, rng)
    torch.cuda.synchronize()
    collect_s = time.perf_counter() - t0
    collect_counts = _counts(mods)
    torch.cuda.reset_peak_memory_stats()
    _reset(mods)
    t0 = time.perf_counter()
    state, metrics = agent.update(state, rollout, rng)
    metrics = {k: float(v) for k, v in metrics.items()}
    torch.cuda.synchronize()
    update_s = time.perf_counter() - t0
    update_counts = _counts(mods)  # the main path ends here
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30

    # where a collect step goes: the act call alone (device work waited for)
    # and the env step alone, each averaged over 20 calls
    t0 = time.perf_counter()
    for _ in range(20):
        agent.act(states, rng)[0].cpu()
    act_ms = (time.perf_counter() - t0) / 20 * 1e3
    t0 = time.perf_counter()
    for _ in range(20):
        env.step(np.zeros((cfg.num_env_per_process, 1), np.float32))
    env_step_ms = (time.perf_counter() - t0) / 20 * 1e3

    acts, logp = rollout.actions, rollout.policy
    with torch.no_grad():
        probe = agent.network(torch.from_numpy(states[:16]).to(dev).float() / 255.0)
    mean_max = probe.policy.abs().max().item()
    log_std = agent.network.log_std.detach().cpu().tolist()
    finite = bool(torch.isfinite(acts).all() and torch.isfinite(logp).all()
                  and all(np.isfinite(v) for v in metrics.values())
                  and np.all(np.isfinite(log_std)))
    expect_collect = {"flash_qkv_fwd": per_rollout, "fused_ffn_fwd": per_rollout}
    expect_update = {k: per_update for k in ("flash_qkv_fwd", "fused_ffn_fwd",
                                             "flash_qkv_bwd", "fused_ffn_bwd")}
    host = host_batch(torch, 8)
    g = np.random.default_rng(SEED + 5)
    host.update(actions=torch.from_numpy(g.uniform(-1, 1, (8, 1)).astype(np.float32)),
                old_policy=torch.from_numpy((g.standard_normal((8, 1)) * 0.3 - 1.0)
                                            .astype(np.float32)),
                int_target=None, rnd_in=None)
    grads = noisy_grad_check(torch, dev, cfg, 1, ActionSpaceType.CONTINUOUS, host,
                             "continuous + NoisyNet")
    log("continuous", config="configs/pendulum_continuous.conf",
        changes=dict(UseNoisyNet=True, env="ContinuousSmokeEnv (no gymnasium)"),
        envs=cfg.num_env_per_process, steps=cfg.num_step, frames=frames,
        epochs=cfg.epoch, mini_batch=cfg.mini_batch, collect_s=collect_s,
        update_s=update_s, iteration_s=collect_s + update_s,
        frames_per_s=frames / (collect_s + update_s), collect_frames_per_s=frames / collect_s,
        step_ms=collect_s / (cfg.num_step + 1) * 1e3, act_ms=act_ms, env_step_ms=env_step_ms,
        launches_per_rollout=collect_counts, expected_per_rollout=expect_collect,
        launches_per_update=update_counts, expected_per_update=expect_update,
        peak_memory_gb=peak_gb, actions_shape=list(acts.shape),
        policy_shape=list(logp.shape), actions_min=acts.min().item(),
        actions_max=acts.max().item(), mean_abs_max=mean_max,
        env_torque_range=env.torque_range, finite=finite, log_std=log_std,
        metrics=metrics, grad_check=grads, episodes=collector.stats.num_episodes,
        card=gpu_name_power())
    check_counts(collect_counts, expect_collect, "continuous: collect")
    check_counts(update_counts, expect_update, "continuous: update")
    check(tuple(acts.shape) == (cfg.num_step, cfg.num_env_per_process, 1)
          and acts.dtype == torch.float32
          and tuple(logp.shape) == (cfg.num_step, cfg.num_env_per_process, 1),
          "continuous: actions [T, N, 1] float32 and log-probs [T, N, 1]")
    check(finite, "continuous: finite actions, log-probs, metrics and log_std")
    check(mean_max <= 1.0 and -2.0 <= env.torque_range[0] <= env.torque_range[1] <= 2.0,
          "continuous: the tanh mean in [-1, 1], the torques in [-2, 2]")
    check(log_std != [-0.5], "continuous: the update moved log_std")
    return {"collect": collect_counts, "update": update_counts}


def modified_rnd_phase(torch, mods, dev, workdir: str, kernel_rows):
    """``configs/synthetic_device_flagship.conf`` with ``TrainMethod =
    modified_RND``, ``UseNoisyNet = True`` and ``ObsNormStep = 1`` through
    ``train.train`` for two iterations at full width, with its launch counts
    (the next-obs embedding pass runs ``depth x 8,192 / feature_chunk``
    launches of K1f and K2f at rate 0 in the warm-up and in each update).
    Then one iteration in pieces from its checkpoint: ``collect`` with its
    host syncs counted (none allowed, the NoisyNet noise included), the
    embedding pass of ``prepare_batch`` alone, and ``update`` with its peak
    memory; K1f and K2f at the pass's shape (``kernel_rows``, from
    ``item5_kernel_shapes``); the gradient of the network and the ``MlpTrunk``
    RND predictor on 8 frames against the CPU copy (``noisy_grad_check``)."""
    import math

    import numpy as np

    from eavit_tpu_torch import train as port_train
    from eavit_tpu_torch.config import EnvType, TrainMethod, load_config
    from eavit_tpu_torch.envs.device_env import make_device_env
    from eavit_tpu_torch.models.layers import Rng
    from eavit_tpu_torch.models.policy import ActionSpaceType
    from eavit_tpu_torch.models.rnd import MlpTrunk
    from eavit_tpu_torch.rl.agent import RNDAgent
    from eavit_tpu_torch.rl.scan_rollout import ScanRolloutCollector
    from eavit_tpu_torch.utils.checkpoint import load_checkpoint

    cuts = dict(obs_norm_step=1, updates=2)
    cfg = load_config(os.path.join(REPO_ROOT, "configs", "synthetic_device_flagship.conf"))
    check(cfg.env_type == EnvType.SYNTHETIC_DEVICE and cfg.vit.dim == 256
          and cfg.vit.depth == DEPTH and cfg.num_env_per_process == NUM_ENVS
          and cfg.num_step == NUM_STEP, "synthetic_device_flagship.conf at full width")
    cfg = cfg.replace(train_method=TrainMethod.MODIFIED_RND, use_noisy_net=True,
                      obs_norm_step=cuts["obs_norm_step"], save_ckpt_every=cuts["updates"],
                      log_name="smoke_modified_rnd",
                      save_model_path=os.path.join(workdir, "ckpt"))
    updates = cuts["updates"]
    frames = cfg.num_step * cfg.num_env_per_process
    chunk = RNDAgent.feature_chunk
    per_pass = cfg.vit.depth * math.ceil(frames / chunk)
    per_rollout = cfg.vit.depth * (cfg.num_step + 1)
    per_update = cfg.vit.depth * cfg.epoch * cfg.mini_batch

    torch.cuda.synchronize()
    _reset(mods)
    t0 = time.perf_counter()
    metrics = port_train.train(cfg, total_updates=updates,
                               log_dir=os.path.join(workdir, "logs"))  # CUDA by default
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    counts = _counts(mods)  # the main path ends here
    # warm-up: a policy rollout and its embedding pass; then per iteration a
    # rollout, the update's embedding pass and its minibatches
    fwd = (updates + 1) * (per_rollout + per_pass) + updates * per_update
    expect = {"flash_qkv_fwd": fwd, "fused_ffn_fwd": fwd,
              "flash_qkv_bwd": updates * per_update, "fused_ffn_bwd": updates * per_update}
    finite = all(np.isfinite(v) for v in metrics.values())

    # one iteration in pieces, as train builds it, from the checkpoint
    path = os.path.join(cfg.save_model_path, cfg.log_name)
    agent = RNDAgent(cfg, 5)
    agent.init_state(cfg.seed)
    state, _ = load_checkpoint(path, agent)
    check(isinstance(agent.rnd_pred.trunk, MlpTrunk)
          and tuple(state.obs_rms.mean.shape) == (1, cfg.vit.dim),
          "modified_RND: the MLP trunk and an obs_rms over the embedding")
    params, env_state = make_device_env(
        cfg.num_env_per_process, seed=cfg.seed, grid=cfg.synthetic_grid,
        stack=cfg.state_stack_size, height=cfg.pre_proc_height, width=cfg.pre_proc_width,
        max_episode_steps=cfg.max_step_per_episode, maze=cfg.synthetic_maze,
        texture=cfg.synthetic_texture, shared_world=cfg.synthetic_shared_world,
        variants=cfg.synthetic_variants, sparse_goal=cfg.synthetic_sparse_goal,
        goal_depth=cfg.synthetic_goal_depth, device=dev)
    collector = ScanRolloutCollector(cfg, agent, params)
    rng = Rng(SEED + 3, agent.device)
    _, env_state, _ = collector.collect(env_state, rng)  # warm: allocator, cuDNN
    (rollout, env_state, _), syncs = host_syncs(
        torch, lambda: collector.collect(env_state, rng))
    _reset(mods)
    t0 = time.perf_counter()
    rollout, env_state, _ = collector.collect(env_state, rng)
    torch.cuda.synchronize()
    collect_s = time.perf_counter() - t0
    collect_counts = _counts(mods)
    _reset(mods)
    t0 = time.perf_counter()
    agent.prepare_batch(state, rollout)
    torch.cuda.synchronize()
    prepare_s = time.perf_counter() - t0
    pass_counts = _counts(mods)
    torch.cuda.reset_peak_memory_stats()
    _reset(mods)
    t0 = time.perf_counter()
    state, m2 = agent.update(state, rollout, rng)
    loss = float(m2["train/loss"])
    torch.cuda.synchronize()
    update_s = time.perf_counter() - t0
    update_counts = _counts(mods)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30

    host = host_batch(torch, 8)
    host["rnd_in"] = torch.from_numpy(np.random.default_rng(SEED + 6).standard_normal(
        (8, cfg.vit.dim)).astype(np.float32))
    grads = noisy_grad_check(torch, dev, cfg, 5, ActionSpaceType.DISCRETE, host,
                             "modified_RND + NoisyNet")
    log("modified_rnd", config="configs/synthetic_device_flagship.conf",
        changes=dict(TrainMethod="modified_RND", UseNoisyNet=True), cuts=cuts,
        envs=cfg.num_env_per_process, steps=cfg.num_step, frames=frames,
        feature_chunk=chunk, train_s=train_s, train_launches=counts,
        expected_train_launches=expect, finite=finite,
        metrics={k: metrics[k] for k in sorted(metrics)}, collect_s=collect_s,
        prepare_batch_s=prepare_s, update_s=update_s, iteration_s=collect_s + update_s,
        frames_per_s=frames / (collect_s + update_s), host_syncs_in_collect=len(syncs),
        host_syncs=syncs[:5], launches_per_rollout=collect_counts,
        launches_next_obs_pass=pass_counts, launches_per_update=update_counts,
        update_peak_memory_gb=peak_gb, grad_check=grads,
        next_obs_pass_kernels={name: {k: kernel_rows[(name, "next_obs")][k] for k in (
            "ms", "bound_ms", "bound_by", "plain_ms", "max_abs_err", "tol")}
            for name in ("flash_qkv_fwd", "fused_ffn_fwd")},
        card=gpu_name_power())
    check_counts(counts, expect, "modified_RND: train")
    check(finite and loss == loss, "modified_RND: finite metrics")
    check(metrics["train/rnd_loss"] > 0.0, "modified_RND: the predictor's loss is live")
    check(not syncs, f"modified_RND: host syncs in collect with NoisyNet on: {syncs}")
    check_counts(collect_counts, {"flash_qkv_fwd": per_rollout, "fused_ffn_fwd": per_rollout},
                 "modified_RND: collect")
    check_counts(pass_counts, {"flash_qkv_fwd": per_pass, "fused_ffn_fwd": per_pass},
                 "modified_RND: the next-obs embedding pass")
    check_counts(update_counts, {"flash_qkv_fwd": per_pass + per_update,
                                 "fused_ffn_fwd": per_pass + per_update,
                                 "flash_qkv_bwd": per_update, "fused_ffn_bwd": per_update},
                 "modified_RND: one update")
    return counts


# ---------------------------------------------------------------------------
# phases 20-22: BYOL and Barlow Twins (Queue 1 item 7), EncoderRemat (item 10)
# ---------------------------------------------------------------------------

SSL_METHODS = {"byol": "BYOL", "barlow": "Barlow-Twins"}
SSL_FWD = {"byol": 4, "barlow": 2}  # backbone forwards of one SSL loss (2 online + 2 target)
SSL_BWD = 2  # and backwards (the two online views)


def ssl_cfg(method: str, workdir: str):
    """The flagship (shared stream, pallas_qkv, fused FFN, dropout 0.1) with
    ``representationLearningMethod`` set, ``SSL_pretraining = True`` and
    ``SSLEpochs = 1``, the heads at ``SSLConfig``'s defaults; Barlow Twins at
    ``Epoch = 1`` to bound its time."""
    from eavit_tpu_torch.config import RepresentationMethod

    cfg = flagship_cfg(True).replace(
        representation_lr_method=RepresentationMethod(SSL_METHODS[method]),
        ssl_pretraining=True, ssl_pretrain_epochs=1, obs_norm_step=1, save_ckpt_every=1,
        log_name=f"smoke_ssl_{method}", save_model_path=os.path.join(workdir, "ckpt"))
    return cfg.replace(epoch=1) if method == "barlow" else cfg


def ssl_phase(torch, mods, dev, workdir: str, method: str, host_timing):
    """``train.train`` for one PPO iteration after one SSL pretraining epoch
    (``ssl_cfg``, nothing cut), with its launch counts: pretraining runs
    ``max(1, Epoch)`` passes of 32 minibatches (``SSL_FWD`` forwards and
    ``SSL_BWD`` backwards a layer each) and 32 evaluation minibatches; each
    update minibatch step runs 1 + ``SSL_FWD`` forwards and 1 + ``SSL_BWD``
    backwards a layer. Then: every loss finite, ``train/loss`` the sum of its
    parts with the representation term, the checkpoint round trip of the
    online SSL modules and the target; one iteration in pieces (a pretraining
    epoch, ``collect``, ``update`` with its peak memory; the minibatch step
    beside phase 5's of this call, ``host_timing``); under BYOL one minibatch
    step's EMA, target' = target * decay + online' * (1 - decay) with equal
    bits, and no gradient on the target; the augmentation on the card against
    the CPU on one set of parameters; the gradient of the joint loss on 8
    frames (``ssl_host_batch``) at dropout 0 against the CPU copy with one
    set of augment parameters given to both (``noisy_grad_check``'s
    criteria)."""
    from eavit_tpu_torch import train as port_train
    from eavit_tpu_torch.envs.builders import make_vector_env
    from eavit_tpu_torch.models.layers import Rng
    from eavit_tpu_torch.models.policy import ActionSpaceType
    from eavit_tpu_torch.ops.augment import AugmentParams, augment
    from eavit_tpu_torch.rl.agent import RNDAgent
    from eavit_tpu_torch.rl.device_rollout import DeviceRolloutCollector
    from eavit_tpu_torch.rl.ssl_pretrain import SSLPretrainer
    from eavit_tpu_torch.utils.checkpoint import BEST_SUFFIXES, load_checkpoint, save_checkpoint

    name = f"ssl_{method}"
    byol = method == "byol"
    cfg = ssl_cfg(method, workdir)
    s = cfg.ssl
    check(cfg.vit.dim == 256 and cfg.vit.depth == DEPTH and cfg.vit.dropout == 0.1
          and cfg.compute_dtype == "bfloat16" and (s.byol_projection_hidden_size,
          s.byol_projection_size, s.byol_moving_average_decay, s.byol_representation_loss_coef,
          tuple(s.barlow_twins_projection_sizes), s.barlow_twins_lambda)
          == (4096, 256, 0.99, 0.01, (8192, 8192, 8192), 0.0051),
          f"{name}: the flagship with the SSL heads at their defaults")
    depth, frames = cfg.vit.depth, cfg.num_step * cfg.num_env_per_process
    n_mb = frames // cfg.batch_size
    passes = max(1, cfg.epoch)
    steps = cfg.epoch * cfg.mini_batch
    per_rollout = depth * (cfg.num_step + 1)
    pre_fwd = depth * passes * 2 * n_mb * SSL_FWD[method]  # training and evaluation
    pre_bwd = depth * passes * n_mb * SSL_BWD
    upd_fwd, upd_bwd = depth * steps * (1 + SSL_FWD[method]), depth * steps * (1 + SSL_BWD)
    fwd, bwd = per_rollout + upd_fwd + pre_fwd, upd_bwd + pre_bwd
    expect = {"flash_qkv_fwd": fwd, "fused_ffn_fwd": fwd, "flash_qkv_bwd": bwd,
              "fused_ffn_bwd": bwd}

    logs = os.path.join(workdir, "logs")
    torch.cuda.synchronize()
    _reset(mods)
    t0 = time.perf_counter()
    metrics = port_train.train(cfg, total_updates=1, log_dir=logs)  # CUDA by default
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    counts = _counts(mods)  # the main path ends here
    check_counts(counts, expect, f"{name}: train")
    finite = all(v == v and abs(v) != float("inf") for v in metrics.values())
    parts = sum(metrics[k] for k in LOSS_PARTS + ("train/representation_loss",))
    check(finite, f"{name}: finite metrics")
    check(metrics["train/representation_loss"] > 0.0, f"{name}: the representation term is live")
    check(abs(metrics["train/loss"] - parts) <= 1e-4 * max(1.0, abs(parts)),
          f"{name}: train/loss {metrics['train/loss']} != sum of parts {parts}")
    with open(os.path.join(logs, f"{cfg.log_name}_scalars.jsonl")) as fh:
        pre_losses = [{k: v for k, v in json.loads(ln).items() if k.startswith("SSL_")}
                      for ln in fh if "SSL_pretraining" in ln]
    check(len(pre_losses) == 1 and all(v == v for v in pre_losses[0].values()),
          f"{name}: one pretraining epoch logged, finite: {pre_losses}")

    # the checkpoint: into a fresh agent, saved again, into another
    path = os.path.join(cfg.save_model_path, cfg.log_name)
    check(os.path.exists(path + BEST_SUFFIXES["ssl_loss"] + ".pt"),
          f"{name}: the best-SSL-loss checkpoint")
    agent = RNDAgent(cfg, 5)
    agent.init_state(cfg.seed)
    keys = ("ssl", "ssl_target") if byol else ("ssl",)
    start = {k: copy.deepcopy(agent._modules()[k].state_dict()) for k in keys}
    state, _ = load_checkpoint(path, agent)
    save_checkpoint(os.path.join(workdir, "again"), agent, state)
    other = RNDAgent(cfg, 5)
    other.init_state(cfg.seed + 1)
    load_checkpoint(os.path.join(workdir, "again"), other)
    mods_a, mods_b = agent._modules(), other._modules()
    same = all(torch.equal(v, mods_b[k].state_dict()[n])
               for k in keys for n, v in mods_a[k].state_dict().items())
    moved = {k: sum(not torch.equal(v, start[k][n]) for n, v in mods_a[k].state_dict().items())
             for k in keys}
    total = {k: len(start[k]) for k in keys}
    check(same, f"{name}: the SSL modules through a checkpoint round trip")
    check(moved == total, f"{name}: every SSL tensor moved in training ({moved} of {total})")
    check((agent.ssl_target is not None) == byol, f"{name}: a target under BYOL only")
    del other

    # one iteration in pieces: a pretraining epoch, collect, update
    env = make_vector_env(cfg)
    collector = DeviceRolloutCollector(cfg, agent, env)  # as train builds it
    rng = Rng(SEED + 3, agent.device)
    states = env.reset()
    rollout, states = collector.collect(states, rng)
    flat = rollout.states.reshape((-1,) + tuple(rollout.states.shape[2:]))
    pretrainer = SSLPretrainer(cfg, agent)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pre_train, pre_eval = pretrainer.epoch(flat, flat, rng)
    pre_train, pre_eval = float(pre_train), float(pre_eval)
    torch.cuda.synchronize()
    pretrain_epoch_s = time.perf_counter() - t0
    _reset(mods)
    t0 = time.perf_counter()
    rollout, states = collector.collect(states, rng)
    torch.cuda.synchronize()
    collect_s = time.perf_counter() - t0
    collect_counts = _counts(mods)
    t0 = time.perf_counter()
    agent.prepare_batch(state, rollout)
    torch.cuda.synchronize()
    prepare_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    _reset(mods)
    t0 = time.perf_counter()
    state, m2 = agent.update(state, rollout, rng)
    loss = float(m2["train/loss"])
    torch.cuda.synchronize()
    update_s = time.perf_counter() - t0
    update_counts = _counts(mods)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    step_ms = (update_s - prepare_s) / steps * 1e3
    check(loss == loss and pre_train == pre_train and pre_eval == pre_eval,
          f"{name}: finite losses in the timed pieces")
    check_counts(collect_counts, {"flash_qkv_fwd": per_rollout, "fused_ffn_fwd": per_rollout},
                 f"{name}: collect")
    check_counts(update_counts, {"flash_qkv_fwd": upd_fwd, "fused_ffn_fwd": upd_fwd,
                                 "flash_qkv_bwd": upd_bwd, "fused_ffn_bwd": upd_bwd},
                 f"{name}: one update")
    target_grads = (None if agent.ssl_target is None else
                    sum(p.grad is not None for p in agent.ssl_target.parameters()))
    check(target_grads in (None, 0), f"{name}: {target_grads} target parameters have a .grad")

    # one minibatch step's EMA, bit for bit
    ema = None
    if byol:
        _, batch, _ = agent.prepare_batch(state, rollout)
        t_before = next(agent.ssl_target.parameters()).detach().clone()
        agent._minibatch_step(batch, torch.arange(cfg.batch_size, device=dev), rng,
                              agent.trainable_parameters())
        online = next(agent.network.feature.parameters()).detach()
        target = next(agent.ssl_target.parameters()).detach()
        decay = s.byol_moving_average_decay
        want = t_before * decay + online * (1.0 - decay)
        ema = dict(parameter="feature.patch_norm_in.weight",
                   moved_by=(target - t_before).abs().max().item(),
                   err_vs_one_minus_decay_times_gap=(
                       target - t_before - (1.0 - decay) * (online - t_before)).abs().max().item(),
                   equal_bits=same_bits(torch, target, want))
        check(ema["equal_bits"] and ema["moved_by"] > 0.0,
              f"{name}: the EMA step is target * decay + online * (1 - decay): {ema}")
        check(all(p.grad is None for p in agent.ssl_target.parameters()),
              f"{name}: a target parameter has a .grad")

    # the augmentation on the card against the CPU, one set of parameters
    params = agent.ssl.draw(torch.Generator().manual_seed(SEED + 13), cfg.batch_size,
                            cfg.pre_proc_height, cfg.pre_proc_width, "cpu")[0]
    on_dev = AugmentParams(*(t.to(dev) for t in params))
    imgs = flat[:cfg.batch_size].float() / 255.0
    aug_err = (augment(imgs, on_dev).cpu() - augment(imgs.cpu(), params)).abs().max().item()
    aug_ms = time_ms(torch, lambda: augment(imgs, on_dev), 10)
    check(aug_err <= 1e-5, f"{name}: the augmentation on the card vs the CPU: {aug_err}")

    host = ssl_host_batch(torch, 8)
    grads = noisy_grad_check(torch, dev, cfg, 5, ActionSpaceType.DISCRETE, host, name)
    log(name, method=SSL_METHODS[method], config="bench.py:flagship_cfg",
        changes=dict(representationLearningMethod=SSL_METHODS[method], SSL_pretraining=True,
                     SSLEpochs=1, **({} if byol else {"Epoch": 1})),
        heads=dict(byol_hidden=s.byol_projection_hidden_size, byol_size=s.byol_projection_size,
                   decay=s.byol_moving_average_decay,
                   barlow_sizes=list(s.barlow_twins_projection_sizes),
                   lambd=s.barlow_twins_lambda),
        envs=cfg.num_env_per_process, steps=cfg.num_step, frames=frames, epochs=cfg.epoch,
        mini_batch=cfg.mini_batch, train_s=train_s, train_launches=counts,
        expected_train_launches=expect, finite=finite,
        metrics={k: metrics[k] for k in sorted(metrics)}, pretrain_losses=pre_losses[0],
        checkpoint_tensors_moved=moved, pretrain_epoch_s=pretrain_epoch_s,
        pretrain_epoch_losses=[pre_train, pre_eval], collect_s=collect_s,
        prepare_batch_s=prepare_s, update_s=update_s, iteration_s=collect_s + update_s,
        frames_per_s=frames / (collect_s + update_s), minibatch_step_ms=step_ms,
        flagship_minibatch_step_ms=(host_timing or {}).get("minibatch_step_ms"),
        update_peak_memory_gb=peak_gb, launches_per_rollout=collect_counts,
        launches_per_update=update_counts, ema=ema, augment_err_vs_cpu=aug_err,
        augment_err_tol=1e-5, augment_view_ms=aug_ms, grad_check=grads,
        card=gpu_name_power())
    return counts


def remat_phase(torch, mods, dev):
    """One flagship minibatch step (256 frames, dropout 0.1, bf16) under
    ``EncoderRemat = none``, ``full`` and ``dots`` on ``pallas_qkv`` (K1) and
    ``pallas`` (K3), each from ``SEED`` with one dropout stream: the policy
    network's gradients under ``full`` and ``dots`` must have the bits of
    ``none`` (the RND predictor's cuDNN convolutions are left out, fault 7);
    the forward kernels launch once more a layer under remat (the recompute);
    the step's peak memory above what it started from, its time over 5
    more steps, and its device time and the card's busy share over 3 traced
    steps (``profile_steps``)."""
    from eavit_tpu_torch.models.layers import Rng
    from eavit_tpu_torch.rl.agent import RNDAgent, TrainBatch

    host = host_batch(torch, MB_FRAMES)
    out = {}
    for attention in ("pallas_qkv", "pallas"):
        attn_fwd, attn_bwd = attention_kernels(attention, True)
        grads0 = None
        for mode in ("none", "full", "dots"):
            cfg = flagship_cfg(True, attention).replace(encoder_remat=mode)
            agent = RNDAgent(cfg, 5)
            agent.init_state(SEED)
            batch = TrainBatch(**{k: v.to(dev) for k, v in host.items()})
            idx = torch.arange(MB_FRAMES, device=dev)
            params = agent.trainable_parameters()
            rng = Rng(SEED + 9, agent.device)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            _reset(mods)
            agent._minibatch_step(batch, idx, rng, params)
            torch.cuda.synchronize()
            counts = _counts(mods)
            peak_gb = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
            grads = {n: p.grad.detach().clone() for n, p in agent.network.named_parameters()}
            t0 = time.perf_counter()
            for _ in range(5):
                agent._minibatch_step(batch, idx, rng, params)
            torch.cuda.synchronize()
            step_ms = (time.perf_counter() - t0) / 5 * 1e3
            device_ms, busy = profile_steps(
                torch, lambda: agent._minibatch_step(batch, idx, rng, params))
            per = 1 if mode == "none" else 2
            expect = {attn_fwd: per * DEPTH, "fused_ffn_fwd": per * DEPTH,
                      **{k: DEPTH for k in (*attn_bwd, "fused_ffn_bwd")}}
            row = dict(launches=counts, expected_launches=expect, peak_memory_gb=peak_gb,
                       step_ms=step_ms, device_ms_per_step=device_ms,
                       traced_window_busy_share=busy)
            if grads0 is None:
                grads0 = grads
            else:
                differ = [n for n, g in grads.items() if not same_bits(torch, g, grads0[n])]
                row["grads_differing"] = differ
                row["grad_max_abs_diff"] = max((grads[n].float() - grads0[n].float())
                                               .abs().max().item() for n in grads)
                check(not differ, f"remat {attention} {mode}: gradients differ from none's "
                      f"in {differ[:5]}")
            check_counts(counts, expect, f"remat {attention} {mode}: one minibatch step")
            out[f"{attention} {mode}"] = row
            del agent, grads
            torch.cuda.empty_cache()
    log("remat", frames=MB_FRAMES, dropout=0.1, compute_dtype="bfloat16",
        parameters=len(grads0), steps=out, card=gpu_name_power())
    return out


# (attention, dropout, compute dtype, patch size) of the one-step route checks:
# patch 4 (N = 443) in both dtypes and patch 3 (N = 786) in bf16
ROUTE_STEPS = (("pallas", 0.1, "bfloat16", 4), ("pallas_qkv", 0.1, "bfloat16", 4),
               ("pallas", 0.0, "bfloat16", 4), ("pallas", 0.1, "float32", 4),
               ("pallas", 0.0, "float32", 4), ("pallas_qkv", 0.1, "float32", 4),
               ("pallas", 0.1, "bfloat16", 3), ("pallas_qkv", 0.1, "bfloat16", 3),
               ("pallas", 0.0, "bfloat16", 3))


def route_kernels(attention: str, dropout: bool, n: int, dtype):
    """The attention kernels a model on ``attention`` runs at N tokens and
    ``Dh`` 32 in ``dtype``: ``(forward, backward)`` launch keys (the
    whole-head bf16 kernels where a head fits, the streaming ones past it and
    in float32)."""
    from eavit_tpu_torch.ops import flash as fl
    from eavit_tpu_torch.ops import flash_dropout as fd
    from eavit_tpu_torch.ops import flash_qkv as fq

    if attention == "pallas_qkv":
        return fq.fwd_kernel(n, 32, dtype), fq.bwd_kernel(n, 32, dtype)
    if dropout:
        return "flash_dropout_fwd", fd.bwd_kernel(n, 32, dtype)
    return "flash_fwd", fl.bwd_kernel(n, 32, dtype)


def patch4_other_routes(torch, mods, dev):
    """One minibatch step of 4 frames on ``pallas`` and ``pallas_qkv`` at the
    long sequences of ``ROUTE_STEPS`` (float32 patch 4, on both routes and
    at dropout 0.1 and 0 on ``pallas``; bf16 patch 4 and patch 3): finite
    gradients, through the route's kernels at that length (depth 3: three
    launches of each). Returns the launches of all the steps together."""
    import dataclasses

    from eavit_tpu_torch.models.layers import Rng
    from eavit_tpu_torch.rl.agent import RNDAgent, TrainBatch

    n = 4
    batch = TrainBatch(**{k: v.to(dev) for k, v in host_batch(torch, n).items()})
    total = {}
    for attention, dropout, dtype, patch in ROUTE_STEPS:
        cfg = flagship_cfg(True, attention).replace(compute_dtype=dtype)
        agent = RNDAgent(cfg.replace(vit=dataclasses.replace(cfg.vit, patch_size=patch,
                                                             dropout=dropout)), 5)
        agent.init_state(SEED)
        torch.cuda.synchronize()
        _reset(mods)
        loss, _ = agent._loss(batch, torch.arange(n, device=dev), Rng(SEED, dev))
        loss.backward()
        torch.cuda.synchronize()
        counts = _counts(mods)
        grads = [p.grad for p in agent.trainable_parameters() if p.grad is not None]
        finite = bool(torch.isfinite(loss).item()) and all(
            torch.isfinite(t).all().item() for t in grads)
        tokens = (84 // patch) ** 2 + 2
        fwd, bwd = route_kernels(attention, dropout > 0, tokens, getattr(torch, dtype))
        expect = {fwd: DEPTH, bwd: DEPTH, "fused_ffn_fwd": DEPTH, "fused_ffn_bwd": DEPTH}
        for k_, c in counts.items():
            total[k_] = total.get(k_, 0) + c
        what = f"patch {patch} ({tokens} tokens) on {attention}, {dtype}, dropout {dropout}"
        log("patch4_route", attention=attention, compute_dtype=dtype, dropout=dropout,
            patch=patch, tokens=tokens, loss=float(loss.detach()), finite=finite,
            grad_tensors=len(grads), launches=counts, expected_launches=expect)
        check(finite and len(grads) > 0, f"{what}: finite gradients")
        check_counts(counts, expect, f"{what}: one minibatch step")
        del agent, loss, grads
        torch.cuda.empty_cache()
    return total


def stream_flagship_phase(torch, fq, fl, fd, dev):
    """The streaming kernels of K1f, K1b, K3b and K4b at the flagship shapes,
    where the wrappers run the whole-head kernels: held to the plain version
    (one bf16 rounding) and timed beside the bound, the plain version and
    SDPA with the same mask (its backward for a backward kernel), so that
    both kernels of each function have their times from one call. K1f at the
    act and minibatch shapes, rate 0.1 and 0; the backward kernels at the
    minibatch, K1b at rate 0.1 and 0, K3b at 0.1."""
    import torch.nn.functional as F

    from eavit_tpu_torch.ops.attention import dual_query_allowed

    h, dh, n, ns, seeds = 8, 32, 198, 2, KERNEL_SEEDS
    scale = dh ** -0.5
    rows = {}
    for use, b in (("act", NUM_ENVS), ("train", MB_FRAMES)):
        g = torch.Generator().manual_seed(b + n + 7)
        q, k, v, do = (torch.randn(b, h, n, dh, generator=g).to(dev, torch.bfloat16)
                       for _ in range(4))
        merged = lambda t: t.transpose(1, 2).reshape(b, n, h * dh).contiguous()  # noqa: E731
        qkv, gm = torch.cat([merged(t) for t in (q, k, v)], -1), merged(do)
        mask = dual_query_allowed(n, n, ns, dev)
        numel, bhn = q.numel(), b * h * n
        nn_flops = 2.0 * b * h * allowed_pairs(n, ns) * dh
        lib_fwd = time_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask), 20)
        calls = {}
        for rate in (0.0, 0.1):
            args = (h, dh, scale, ns, seeds, rate)
            calls[("flash_qkv_fwd_stream", rate)] = (
                fq, lambda args=args: fq.flash_qkv_fwd(qkv, *args, kernel="stream"),
                lambda args=args: fq.flash_qkv_fwd_plain(qkv, *args), 4 * 2 * numel + 4 * bhn,
                2, lib_fwd)
        if use == "train":
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            o_lib = F.scaled_dot_product_attention(*leaves, attn_mask=mask)
            lib_bwd = time_ms(torch, lambda: torch.autograd.grad(
                o_lib, leaves, do, retain_graph=True), 10)
            del o_lib, leaves
            for rate in (0.0, 0.1):
                args = (h, dh, scale, ns, seeds, rate)
                lse1 = fq.flash_qkv_fwd(qkv, *args)[1]
                calls[("flash_qkv_bwd_stream", rate)] = (
                    fq, lambda a=args, l1=lse1: (fq.flash_qkv_bwd(qkv, l1, gm, *a, kernel="stream"),),
                    lambda a=args, l1=lse1: (fq.flash_qkv_bwd_plain(qkv, l1, gm, *a),),
                    7 * 2 * numel + 4 * bhn, 5, lib_bwd)
            lse3 = fd.flash_dropout_fwd(q, k, v, seeds, 0.1, scale, ns)[1]
            bargs = (q, k, v, lse3, do, seeds, 0.1, scale, ns)
            calls[("flash_dropout_bwd_stream", 0.1)] = (
                fd, lambda: fd.flash_dropout_bwd(*bargs, kernel="stream"),
                lambda: fd.flash_dropout_bwd_plain(*bargs), 7 * 2 * numel + 4 * bhn, 5, lib_bwd)
            o4, lse4 = fl.flash_fwd(q, k, v, scale, ns)
            calls[("flash_bwd_stream", 0.0)] = (
                fl, lambda: fl.flash_bwd(q, k, v, o4, lse4, do, scale, ns, kernel="stream"),
                lambda: fl.flash_bwd_plain(q, k, v, o4, lse4, do, scale, ns),
                8 * 2 * numel + 4 * bhn, 5, lib_bwd)
        for (name, rate), (mod, call, plain, nbytes, products, lib) in calls.items():
            got = once(mod, name, call)
            want = plain()
            torch.cuda.synchronize()
            outs, refs = (got[:-1], want[:-1]) if name.startswith("flash_qkv_fwd") else (got, want)
            big = max(t.float().abs().max().item() for t in refs)
            tol = 1e-2 + 8e-3 * big
            err = max((a.float() - r.float()).abs().max().item() for a, r in zip(outs, refs))
            same = all(torch.equal(a, b_) for a, b_ in zip(got, call()))
            del got, want, outs, refs
            bms, by = bound_ms(nbytes, products * nn_flops, "bfloat16")
            rows[(name, use, rate)] = row = dict(
                kernel=name, use=use, b=b, h=h, n=n, dim_head=dh, num_special=ns, rate=rate,
                dtype="bfloat16", max_abs_err=err, tol=tol, deterministic=same,
                ms=time_ms(torch, call, 20), plain_ms=time_ms(torch, plain, 2, warmup=1),
                library_ms=lib, bound_ms=bms, bound_by=by)
            log("kernel", **row)
            check(err <= tol and same, f"{name} {row}")
        del q, k, v, do, qkv, gm, calls
        torch.cuda.empty_cache()
    return rows


def stream_kernel(name: str) -> str:
    """The launch key of a function's streaming kernel: K1f, K1b, K3b and K4b
    have a whole-head kernel beside it, K3f and K4f only the streaming one."""
    two = ("flash_qkv_fwd", "flash_qkv_bwd", "flash_dropout_bwd", "flash_bwd")
    return name + "_stream" if name in two else name


# [B, H, Dh] at the long sequences of patch 3 (N = 786) and patch 2 (1,766)
LONG_N = (786, 1766)
LONG_BHD = (16, 8, 32)


def long_n_phase(torch, fq, fl, fd, dev):
    """Each of the six attention functions of K1, K3 and K4 on its streaming
    kernel, in bf16 and float32, launched once at ``[16, 8, N, 32]`` for N =
    786 and 1,766 and held to its plain version (one bf16 rounding of each
    output, or 1e-4 of its scale in float32; lse within 1e-4); timed beside
    the bytes bound, the plain version and, in bf16, SDPA with the same mask
    at rate 0 (its backward for a backward kernel); with each kernel's shared
    memory, a function of Dh and the dtype alone."""
    import torch.nn.functional as F

    from eavit_tpu_torch.ops.attention import dual_query_allowed

    b, h, dh = LONG_BHD
    ns, seeds, rate, scale = 2, KERNEL_SEEDS, 0.1, dh ** -0.5
    smem = {"flash_qkv_fwd": lambda dt: [fq.fwd_smem(dh, dt)],
            "flash_qkv_bwd": lambda dt: list(fq.bwd_smem(dh, dt)),
            "flash_fwd": lambda dt: [fl.fwd_smem(dh, dt)],
            "flash_bwd": lambda dt: list(fl.bwd_smem(dh, dt)),
            "flash_dropout_fwd": lambda dt: [fd.fwd_smem(dh, dt)],
            "flash_dropout_bwd": lambda dt: list(fd.bwd_smem(dh, dt))}
    mods = {"flash_qkv": fq, "flash": fl, "flash_dropout": fd}
    rows = {}
    for n in LONG_N:
        pair_flops = 2.0 * b * h * allowed_pairs(n, ns) * dh  # one [N, N] x [N, Dh] product
        mask = dual_query_allowed(n, n, ns, dev)
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[-1]
            g = torch.Generator().manual_seed(n)
            q, k, v, do = (torch.randn(b, h, n, dh, generator=g).to(dev, dtype)
                           for _ in range(4))
            numel, esize, bhn = q.numel(), q.element_size(), b * h * n
            merged = lambda t: t.transpose(1, 2).reshape(b, n, h * dh).contiguous()  # noqa: E731
            qkv, gm = torch.cat([merged(t) for t in (q, k, v)], -1), merged(do)
            args = (h, dh, scale, ns, seeds, rate)
            lse1 = fq.flash_qkv_fwd(qkv, *args)[1]
            o4, lse4 = fl.flash_fwd(q, k, v, scale, ns)
            lse3 = fd.flash_dropout_fwd(q, k, v, seeds, rate, scale, ns)[1]
            fwd_bytes, bwd_bytes = 4 * numel * esize + 4 * bhn, 7 * numel * esize + 4 * bhn
            calls = {  # kernel -> (call, plain call, bytes moved, products)
                "flash_qkv_fwd": (lambda: fq.flash_qkv_fwd(qkv, *args, kernel="stream"),
                                  lambda: fq.flash_qkv_fwd_plain(qkv, *args), fwd_bytes, 2),
                "flash_qkv_bwd": (lambda: (fq.flash_qkv_bwd(qkv, lse1, gm, *args,
                                                            kernel="stream"),),
                                  lambda: (fq.flash_qkv_bwd_plain(qkv, lse1, gm, *args),),
                                  bwd_bytes, 5),
                "flash_fwd": (lambda: fl.flash_fwd(q, k, v, scale, ns),
                              lambda: fl.flash_fwd_plain(q, k, v, scale, ns), fwd_bytes, 2),
                "flash_bwd": (lambda: fl.flash_bwd(q, k, v, o4, lse4, do, scale, ns,
                                                   kernel="stream"),
                              lambda: fl.flash_bwd_plain(q, k, v, o4, lse4, do, scale, ns),
                              bwd_bytes + numel * esize, 5),
                "flash_dropout_fwd": (
                    lambda: fd.flash_dropout_fwd(q, k, v, seeds, rate, scale, ns),
                    lambda: fd.flash_dropout_fwd_plain(q, k, v, seeds, rate, scale, ns),
                    fwd_bytes, 2),
                "flash_dropout_bwd": (
                    lambda: fd.flash_dropout_bwd(q, k, v, lse3, do, seeds, rate, scale, ns,
                                                 kernel="stream"),
                    lambda: fd.flash_dropout_bwd_plain(q, k, v, lse3, do, seeds, rate, scale,
                                                       ns),
                    bwd_bytes, 5),
            }
            lib = {"fwd": None, "bwd": None}
            if dtype == torch.bfloat16:  # yardsticks: SDPA with the same mask, rate 0
                lib["fwd"] = time_ms(torch, lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask), 10)
                leaves = [t.clone().requires_grad_() for t in (q, k, v)]
                o_lib = F.scaled_dot_product_attention(*leaves, attn_mask=mask)
                lib["bwd"] = time_ms(torch, lambda: torch.autograd.grad(
                    o_lib, leaves, do, retain_graph=True), 10)
                del o_lib, leaves
            for name, (call, plain, nbytes, products) in calls.items():
                mod = mods[name.rsplit("_", 1)[0]]
                name = stream_kernel(name)
                got = once(mod, name, call)
                want = plain()
                torch.cuda.synchronize()
                fwd = name.endswith("fwd")
                outs, refs = (got[:-1], want[:-1]) if fwd else (got, want)
                big = max(t.float().abs().max().item() for t in refs)
                tol = 1e-2 + 8e-3 * big if dtype == torch.bfloat16 else 1e-4 * max(1.0, big)
                err = max((a.float() - r.float()).abs().max().item() for a, r in zip(outs, refs))
                lse_err = (got[-1] - want[-1]).abs().max().item() if fwd else 0.0
                del got, want, outs, refs
                bms, by = bound_ms(nbytes, products * pair_flops, dname)
                rows[(name, n, dname)] = row = dict(
                    kernel=name, b=b, h=h, n=n, dim_head=dh, num_special=ns, dtype=dname,
                    rate=0.0 if name in ("flash_fwd", "flash_bwd") else rate,
                    max_abs_err=err, tol=tol, lse_err=lse_err, lse_tol=1e-4,
                    ms=time_ms(torch, call, 5), plain_ms=time_ms(torch, plain, 2, warmup=1),
                    library_ms=lib["fwd" if fwd else "bwd"], bound_ms=bms, bound_by=by,
                    smem_bytes=smem[name.removesuffix("_stream")](dtype))
                check(err <= tol and lse_err <= 1e-4, f"{name} at N = {n}: {row}")
            del q, k, v, do, qkv, gm, lse1, o4, lse4, lse3, calls
            torch.cuda.empty_cache()
    log("long_n", shape=[*LONG_BHD[:2], "N", dh], n=list(LONG_N),
        kernels={f"{k[0]} {k[2]} N={k[1]}": r for k, r in rows.items()})
    return rows


# ---------------------------------------------------------------------------
# the HF flavour: DualTokenViTHG at ViTHGConfig's defaults (Queue 1, item 8)
# ---------------------------------------------------------------------------

HG_EPOCH = EPOCH  # epochs of the HG iteration through train
# the criteria of the HG network's gradient against its CPU copy. Float32 as
# GRAD_CRITERIA. bf16: the HF flavour's residual stream is bf16 (as in JAX),
# rounded after each of its 24 sublayers, and the card's and the CPU's bf16
# Dense layers sum in other orders, so the two copies' features round apart
# (the port's kernels do not add to it: the reading moves under 3% with K1
# and K2 on their plain versions). bf16's unit roundoff grown by the root of
# those 24 independent roundings; inside grad_check's own bf16 bound of 5e-2.
# So the bf16 reading measures two BLAS libraries' rounding, not the port:
# the float32 criteria (1.2e-6 with K2 plain, 2^-16 with every kernel) are
# what hold the kernels at the HF widths. trace_hg_grad.py reads the bf16 gap
# by depth and seed against this model: it holds at SEED, not at every seed
# (PERF.md), so the bf16 gradient is also held to HG_BF16_REFERENCE
HG_GRAD_CRITERIA = {"float32": GRAD_CRITERIA["float32"],
                    "bfloat16": 2.0 ** -9 * (2 * 12) ** 0.5}
# the card's bf16 gradient no farther from the CPU copy's float32 gradient
# than this many times the CPU copy's own bf16 gradient is: a kernel may add
# no more error than a second plain bf16 computation has (the factor of 2 is
# FlashAttention's tests' rule for a kernel against its plain version)
HG_BF16_REFERENCE = 2.0


def hg_cfg(attention: str = "pallas_qkv"):
    """The flagship's settings (``original_RND``, bf16, fused FFN, shared
    patch stream, 64 host envs x 128 steps) with the HF-flavour backbone at
    ``ViTHGConfig``'s defaults: hidden 1,024, 12 layers, 16 heads of 64,
    intermediate 3,072, patch 12 (49 patches, 51 tokens), qkv bias, LayerNorm
    eps 1e-12, dropout 0."""
    from eavit_tpu_torch.config import ViTHGConfig, ViTImplementation

    return flagship_cfg(True, attention).replace(
        vit_implementation_type=ViTImplementation.HG, vit_hg=ViTHGConfig())


def hg_widths(cfg):
    """``(heads, dim_head, hidden, intermediate, tokens)`` of the HG backbone
    in shared-stream mode."""
    h = cfg.vit_hg
    heads = h.num_attention_heads
    return (heads, h.hidden_size // heads, h.hidden_size, h.intermediate_size,
            (cfg.pre_proc_height // h.patch_size) ** 2 + 2)


def hg_path_ffn_dtype(torch, ff, agent, dev) -> str:
    """The dtype the HG path hands K2f, read from one act: under bf16 the HF
    flavour's residual stream is bf16 (its patch projection's output), so
    the fused FFN runs in bf16, as the JAX module's does."""
    from eavit_tpu_torch.models.layers import Rng

    seen, f = set(), ff.fused_ffn_fwd

    def spy(x2, *a, **kw):
        seen.add(str(x2.dtype).split(".")[-1])
        return f(x2, *a, **kw)

    ff.fused_ffn_fwd = spy
    try:
        agent.act(torch.zeros(2, 4, 84, 84, dtype=torch.uint8, device=dev), Rng(SEED, dev))
    finally:
        ff.fused_ffn_fwd = f
    check(len(seen) == 1, f"hg: one K2f dtype on the path, saw {seen}")
    return seen.pop()


def hg_kernel_shapes(torch, fq, ff, kp, dev):
    """K1f and K1b whole-head at ``Dh`` 64 on ``[64 | 256, 51, 3,072]`` bf16,
    K2f and K2b on the split path at (1,024, 3,072) on 3,264 and 13,056 rows
    in both dtypes, rates 0 and 0.1, each against its plain version and
    timed beside its bound and, where one exists, one PyTorch call (SDPA), or
    the ``F.layer_norm`` to ``F.linear`` chain (``ffn_chain_ms``: float32 and
    bf16, and the bf16 chain's autograd backward beside K2b)."""
    heads, dh, hid, inner, n = hg_widths(hg_cfg())
    eps = hg_cfg().vit_hg.layer_norm_eps
    rows = {}
    for use, b in (("hg_act", NUM_ENVS), ("hg_train", MB_FRAMES)):
        rows.update(k1f_rows(torch, fq, dev, use, b, n, 2, (0.0, 0.1), heads, dh))
    rows.update(k1b_rows(torch, fq, dev, MB_FRAMES, n, 2, heads, dh))
    both = (torch.float32, torch.bfloat16)
    for r in (NUM_ENVS * n, MB_FRAMES * n):
        rows.update(k2f_rows(torch, ff, kp, dev, r, both, (0.0, 0.1), hid, inner, eps))
    rows.update(k2b_rows(torch, ff, dev, MB_FRAMES * n, both, hid, inner, eps))
    return rows


def hg_step(torch, mods, dev, attention: str):
    """One HG minibatch step of 256 frames on ``attention`` (``pallas``: K4 at
    dropout 0; ``pallas_stream``: K5), with its launches (one forward and
    one backward of each kernel a layer), wall time over 5 steps and device
    time and busy share from ``torch.profiler`` over 3."""
    from eavit_tpu_torch.models.layers import Rng
    from eavit_tpu_torch.ops import flash as fl
    from eavit_tpu_torch.rl.agent import RNDAgent, TrainBatch

    cfg = hg_cfg(attention)
    depth, dropout, _ = backbone(cfg)
    heads, dh, _, _, n = hg_widths(cfg)
    agent = RNDAgent(cfg, 5)
    agent.init_state(SEED)
    batch = TrainBatch(**{k: v.to(dev) for k, v in host_batch(torch, MB_FRAMES).items()})
    idx = torch.arange(MB_FRAMES, device=dev)
    params = agent.trainable_parameters()
    rng = Rng(SEED + 5, dev)

    def step():
        return agent._minibatch_step(batch, idx, rng, params)

    step()  # warm
    torch.cuda.synchronize()
    _reset(mods)
    loss = float(step()["train/loss"])
    counts = _counts(mods)
    fwd, bwds = attention_kernels(attention, dropout > 0)
    if attention == "pallas":
        bwds = (fl.bwd_kernel(n, dh, torch.bfloat16),)
    expect = {k: depth for k in (fwd, *bwds, "fused_ffn_fwd", "fused_ffn_bwd")}
    check_counts(counts, expect, f"hg, {attention}: one minibatch step")
    check(loss == loss, f"hg, {attention}: finite loss")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / 5 * 1e3
    device_ms, share = profile_steps(torch, step)
    row = dict(attention=attention, frames=MB_FRAMES, tokens=n, launches=counts,
               expected_launches=expect, step_ms=step_ms, device_ms_per_step=device_ms,
               traced_busy_share=share, loss=loss)
    log("hg_step", **row)
    return row


def hg_phase(torch, mods, dev, workdir: str):
    """The HF flavour at ``ViTHGConfig``'s defaults (``hg_cfg``) through
    ``train.train`` for one iteration of 64 x 128 frames and ``HG_EPOCH`` x 32
    minibatches, its launches exact (12 layers x 129 acts of K1f and K2f a
    rollout, 12 x 128 of K1f, K2f, K1b and K2b an update), one iteration in
    pieces (``collect_s``, ``update_s``, frames/s, the update's peak memory,
    the card's busy share of a minibatch step); the kernels at its shapes
    (``hg_kernel_shapes``); one minibatch step on ``pallas`` and on
    ``pallas_stream`` (``hg_step``); the gradient of the network and the RND
    predictor on 8 frames that differ (``ssl_host_batch``) against the CPU
    copy (``noisy_grad_check`` at ``HG_GRAD_CRITERIA``; the bf16 one also
    against a float32 CPU copy at ``HG_BF16_REFERENCE``)."""
    from eavit_tpu_torch.models.policy import ActionSpaceType
    from eavit_tpu_torch.models.vit import DualTokenViTHG
    from eavit_tpu_torch.ops import flash_qkv as fq
    from eavit_tpu_torch.ops import fused_ffn as ff
    from eavit_tpu_torch.ops import kernel_prng as kp
    from eavit_tpu_torch.rl.agent import RNDAgent

    cfg = hg_cfg()
    h = cfg.vit_hg
    heads, dh, hid, inner, n = hg_widths(cfg)
    check((hid, h.num_hidden_layers, heads, dh, inner, h.patch_size, h.qkv_bias,
           h.layer_norm_eps, cfg.compute_dtype) == (1024, 12, 16, 64, 3072, 12, True, 1e-12,
                                                    "bfloat16"),
          "hg: ViTHGConfig's defaults under bf16")
    check(fq.fwd_kernel(n, dh, torch.bfloat16) == "flash_qkv_fwd"
          and fq.bwd_kernel(n, dh, torch.bfloat16) == "flash_qkv_bwd",
          "hg: K1's whole-head kernels take 51 tokens at Dh 64")
    probe = RNDAgent(cfg, 5)
    probe.init_state(SEED)
    check(isinstance(probe.network.feature, DualTokenViTHG), "hg: the HF backbone")
    n_params = sum(p.numel() for p in probe.network.feature.parameters())
    ffn_dtype = hg_path_ffn_dtype(torch, ff, probe, dev)
    del probe

    counts, timing = training_path(torch, mods, dev, shared=True, epochs=HG_EPOCH, updates=1,
                                   workdir=workdir, pieces=True, base_cfg=cfg)
    rows = hg_kernel_shapes(torch, fq, ff, kp, dev)
    steps = {a: hg_step(torch, mods, dev, a) for a in ("pallas", "pallas_stream")}
    grads = noisy_grad_check(torch, dev, cfg, 5, ActionSpaceType.DISCRETE,
                             ssl_host_batch(torch, 8), "hg", criteria=HG_GRAD_CRITERIA,
                             bf16_reference=HG_BF16_REFERENCE)
    log("hg", hidden=hid, layers=h.num_hidden_layers, heads=heads, dim_head=dh,
        intermediate=inner, patch=h.patch_size, tokens=n, encoder_parameters=n_params,
        epochs=HG_EPOCH, path_ffn_dtype=ffn_dtype, train_launches=counts,
        **{k: timing[k] for k in ("collect_s", "update_s", "iteration_s", "frames_per_s",
                                  "minibatch_step_ms", "device_busy_share",
                                  "update_peak_memory_gb", "update_peak_above_start_gb",
                                  "launches_per_rollout", "launches_per_update")},
        steps=steps, grad_check=grads)
    return dict(counts=counts, timing=timing, rows=rows, steps=steps, ffn_dtype=ffn_dtype,
                tokens=n)


# ---------------------------------------------------------------------------
# the host-env collectors side by side (Queue 1, item 4)
# ---------------------------------------------------------------------------


class HalfRecorder:
    """A fleet with ``step_slice`` that keeps each half's states as the env
    returns them (the pipelined collector's lockstep check)."""

    def __init__(self, env):
        self.env, self.num_envs, self.action_space_n = env, env.num_envs, env.action_space_n
        self.rec = {}

    def reset(self):
        self._initial = self.env.reset()
        self.rec = {}
        return self._initial

    def step(self, actions):
        return self.env.step(actions)

    def step_slice(self, lo, hi, actions):
        out = self.env.step_slice(lo, hi, actions)
        self.rec.setdefault(lo, [self._initial[lo:hi].copy()]).append(out[0].copy())
        return out


def device_rollout_phase(torch, mods, dev):
    """The flagship's host-env rollout (64 envs x 128 steps) by the three
    collectors: ``RolloutCollector``, ``DeviceRolloutCollector`` serial, and
    pipelined (``AsyncEnvPool = True``; the synthetic fleet has
    ``step_slice``). For each: launches of one collect (the pipelined one
    acts on two halves of 32 frames: 2 x 3 x 129 of K1f and K2f), its
    ``collect_s`` (a second collect, warm), and the card's busy share of a
    collect (device time under ``torch.profiler`` over ``collect_s``). The
    serial rollout equals ``RolloutCollector``'s bit for bit on one ``Rng``
    seed; the pipelined one keeps each half's device stacks in lockstep with
    the env's states."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from eavit_tpu_torch.envs.synthetic import SyntheticVectorEnv
    from eavit_tpu_torch.models.layers import Rng
    from eavit_tpu_torch.rl.agent import RNDAgent
    from eavit_tpu_torch.rl.device_rollout import DeviceRolloutCollector
    from eavit_tpu_torch.rl.rollout import RolloutCollector

    cfg = flagship_cfg(True)
    agent = RNDAgent(cfg, 5)
    agent.init_state(SEED)
    depth = cfg.vit.depth
    kinds = (("rollout_collector", RolloutCollector, cfg),
             ("device_serial", DeviceRolloutCollector, cfg),
             ("device_pipelined", DeviceRolloutCollector, cfg.replace(async_env_pool=True)))
    out, first = {}, {}
    for name, cls, c in kinds:
        env = HalfRecorder(SyntheticVectorEnv(NUM_ENVS, seed=42,
                                              max_episode_steps=cfg.max_step_per_episode))
        col = cls(c, agent, env)
        check(getattr(col, "pipelined", False) == (name == "device_pipelined"),
              f"device_rollout: {name} pipelines as asked")
        states = env.reset()
        torch.cuda.synchronize()
        _reset(mods)
        rollout, states = col.collect(states, Rng(SEED + 21, dev))
        torch.cuda.synchronize()
        counts = _counts(mods)
        acts = (2 if name == "device_pipelined" else 1) * (cfg.num_step + 1)
        check_counts(counts, {"flash_qkv_fwd": depth * acts, "fused_ffn_fwd": depth * acts},
                     f"device_rollout, {name}: collect")
        first[name] = (rollout, {lo: list(v) for lo, v in env.rec.items()})
        t0 = time.perf_counter()
        col.collect(states, Rng(SEED + 22, dev))
        torch.cuda.synchronize()
        collect_s = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            col.collect(states, Rng(SEED + 23, dev))
            torch.cuda.synchronize()
        act = device_activity(prof, 1)
        device_s = sum(act[2].values()) / 1e3 if act else None
        out[name] = dict(collect_s=collect_s, frames_per_s=NUM_ENVS * NUM_STEP / collect_s,
                         step_ms=collect_s / (cfg.num_step + 1) * 1e3, launches=counts,
                         device_s=device_s,
                         busy_share=device_s / collect_s if act else None)

    ref, ours = first["rollout_collector"][0], first["device_serial"][0]
    equal = {f: bool(same_bits(torch, getattr(ref, f), getattr(ours, f))) for f in ref._fields}
    rollout, rec = first["device_pipelined"]
    h = NUM_ENVS // 2
    states, nxt = rollout.states.cpu().numpy(), rollout.next_obs.cpu().numpy()
    lockstep = all(len(rec[lo]) == cfg.num_step + 1 and all(
        np.array_equal(states[t, lo:lo + h], rec[lo][t])
        and np.array_equal(nxt[t, lo:lo + h, 0], rec[lo][t + 1][:, -1])
        for t in range(cfg.num_step)) for lo in (0, h))
    finite = bool(torch.isfinite(rollout.value_ext).all() and torch.isfinite(rollout.policy).all())
    log("device_rollout", envs=NUM_ENVS, steps=NUM_STEP, half_act_shape=[h, 198, 768],
        serial_equals_rollout_collector=equal, pipelined_lockstep=lockstep,
        pipelined_finite=finite, **out)
    check(all(equal.values()), f"device_rollout: serial rollout vs RolloutCollector's {equal}")
    check(lockstep and finite, "device_rollout: pipelined rollout in lockstep with the env")
    return out


DP_RANKS, DP_RANK_ENVS = 2, 32  # the gloo ranks on one card, and each one's envs


def _dp_cfg(workdir: str, tag: str, **kw):
    """The flagship (shared stream, ``pallas_qkv``, bf16, dropout 0.1) as
    ``train.train`` runs it in the ``dp`` phase."""
    return flagship_cfg(True).replace(obs_norm_step=1, save_ckpt_every=2, log_name=f"dp_{tag}",
                                      save_model_path=os.path.join(workdir, tag), **kw)


def _tree_leaves(tree):
    """The leaves of a checkpoint payload in a fixed order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree, key=str) for x in _tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _tree_leaves(v)]
    return [tree]


def _dp_rank(rank: int, workdir: str) -> None:
    """One of ``DP_RANKS`` gloo ranks on ``cuda:0`` (a spawned process): two
    flagship iterations (``Epoch = 1``: every all-reduce goes through the
    host) through ``train.train`` with ``DP_RANK_ENVS`` envs;
    then, from rank 0's checkpoint, ``obs_rms`` pooled over the ranks'
    next-obs of eight random steps of each rank's own fleet. Writes
    ``rank<r>.pt`` in ``workdir``; its ``train`` log holds the replica's
    parameter digest."""
    import numpy as np
    import torch

    from eavit_tpu_torch import train as port_train
    from eavit_tpu_torch.envs.builders import make_vector_env
    from eavit_tpu_torch.parallel import dp
    from eavit_tpu_torch.utils.checkpoint import load_checkpoint

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.stdout = open(os.path.join(workdir, f"rank{rank}.out"), "w")  # the train logs
    dp.init_distributed(f"file://{os.path.join(workdir, 'gloo_store')}", DP_RANKS, rank,
                        backend="gloo", timeout=600)
    try:
        cfg = _dp_cfg(workdir, "two_ranks", num_env_per_process=DP_RANK_ENVS,
                      data_axis_size=DP_RANKS, epoch=1)
        t0 = time.perf_counter()
        metrics = port_train.train(cfg, total_updates=2, log_dir=os.path.join(workdir, "logs"),
                                   device="cuda:0")  # the named device: both ranks on it
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        torch.distributed.barrier()  # rank 0's checkpoint is on disk
        agent = dp.build_agent(cfg, 5, device="cuda:0")
        state = agent.init_state(cfg.seed)
        state, _ = load_checkpoint(os.path.join(cfg.save_model_path, cfg.log_name), agent)
        env = make_vector_env(cfg, rank=rank)
        env.reset()
        rng = np.random.default_rng(rank)
        frames = np.concatenate([env.step(rng.integers(0, 5, DP_RANK_ENVS))[0][:, -1:]
                                 for _ in range(8)])
        after = agent.update_obs_rms(state, frames).obs_rms
        torch.save({"metrics": metrics, "train_s": train_s, "frames": torch.from_numpy(frames),
                    "before": [t.cpu() for t in state.obs_rms],
                    "after": [t.cpu() for t in after],
                    "device": str(agent.device), "backend": torch.distributed.get_backend()},
                   os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def _all_reduce_cost(torch, cfg):
    """``dp.all_reduce_mean_`` of gradients shaped as the trainable
    parameters of ``cfg``'s agent, over the initialised group: host time of
    a call that ends in a synchronise, and device time (CUDA events) of a
    call among back-to-back calls."""
    from eavit_tpu_torch.parallel import dp
    from eavit_tpu_torch.rl.agent import RNDAgent

    grads = [torch.randn_like(p) for p in RNDAgent(cfg, 5).trainable_parameters()]
    group, iters = dp.default_group(), 50

    def call():
        dp.all_reduce_mean_(grads, group)

    call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        call()
        torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / iters * 1e3
    device_ms = time_ms(torch, call, iters)
    return dict(tensors=len(grads), elements=sum(g.numel() for g in grads), host_ms=host_ms,
                device_ms=device_ms, host_s_per_update=host_ms * EPOCH * MINI_BATCH / 1e3)


def dp_phase(torch, mods, dev, workdir: str, train_launches=None):
    """``dp`` (Queue 1 item 9): data parallelism on the card. (1) An NCCL
    group of one: the flagship through ``train.train`` for two iterations
    without a process group and again with it, in cuDNN's deterministic mode
    (its convolution backward has other bits run to run otherwise, fault 7),
    in turns (without, with, with, without): parameters, optimizer state,
    normalisers (the checkpoints) and metrics equal bit for bit in all four,
    K1f, K1b, K2f and K2b launched as in the ``train`` line, the gradient
    all-reduce run once a minibatch; each arm's frames/s, and one gradient
    all-reduce timed alone. (2)
    ``DP_RANKS`` gloo ranks on this card (spawned, ``cuda:0``,
    ``DP_RANK_ENVS`` envs each, ``Epoch = 1``) for two iterations: equal
    parameter digests, equal pooled metrics, and ``obs_rms`` pooled over the
    ranks' next-obs equal to one ``rms_update`` over both on the card (the
    mean within 1e-6
    of itself, the variance within 1e-6 of the frames' second moment, where
    ``sumsq / n - mean^2`` rounds; the count exactly)."""
    import multiprocessing

    import torch.distributed as dist

    from eavit_tpu_torch import train as port_train
    from eavit_tpu_torch.parallel import dp
    from eavit_tpu_torch.rl import normalizer as norm

    os.makedirs(workdir, exist_ok=True)
    updates, frames = 2, NUM_STEP * NUM_ENVS
    per_update, per_rollout = DEPTH * EPOCH * MINI_BATCH, DEPTH * (NUM_STEP + 1)
    expect = {**{k: updates * (per_rollout + per_update) for k in ("flash_qkv_fwd",
                                                                     "fused_ffn_fwd")},
              **{k: updates * per_update for k in ("flash_qkv_bwd", "fused_ffn_bwd")}}
    calls = {"all_reduce": 0}
    all_reduce = dist.all_reduce

    def counted(*a, **kw):
        calls["all_reduce"] += 1
        return all_reduce(*a, **kw)

    runs, reduce_cost = [], {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    dist.all_reduce = counted
    try:
        for i, tag in enumerate(("plain", "group_of_one", "group_of_one", "plain")):
            if tag == "group_of_one":
                dp.init_distributed(f"file://{os.path.join(workdir, 'nccl_store')}", 1, 0,
                                    backend="nccl", timeout=600)
            cfg = _dp_cfg(workdir, f"{tag}_{i}")
            calls["all_reduce"] = 0
            torch.cuda.synchronize()
            _reset(mods)
            t0 = time.perf_counter()
            metrics = port_train.train(cfg, total_updates=updates,
                                       log_dir=os.path.join(workdir, "logs"))
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            counts = _counts(mods)  # the main path ends here
            reduces = calls["all_reduce"]
            backend = dist.get_backend() if dist.is_initialized() else None
            if dist.is_initialized():
                if not reduce_cost:  # one gradient all-reduce alone, on the flagship's shapes
                    reduce_cost = _all_reduce_cost(torch, cfg)
                dist.destroy_process_group()
            payload = torch.load(os.path.join(cfg.save_model_path, cfg.log_name + ".pt"),
                                 map_location="cpu", weights_only=True)
            runs.append(dict(tag=tag, metrics=metrics, train_s=train_s, counts=counts,
                             all_reduce_calls=reduces, backend=backend,
                             leaves=_tree_leaves(payload)))
    finally:
        dist.all_reduce = all_reduce
        torch.backends.cudnn.deterministic = deterministic
        if dist.is_initialized():
            dist.destroy_process_group()
    plain, one = runs[0], runs[1]
    same_state = all(len(plain["leaves"]) == len(r["leaves"]) and all(
        same_bits(torch, a, b) if isinstance(a, torch.Tensor) else a == b
        for a, b in zip(plain["leaves"], r["leaves"])) for r in runs[1:])
    same_metrics = all(plain["metrics"] == r["metrics"] for r in runs[1:])
    grad_reduces = updates * EPOCH * MINI_BATCH
    fps = {tag: [updates * frames / r["train_s"] for r in runs if r["tag"] == tag]
           for tag in ("plain", "group_of_one")}

    # two gloo ranks on this card
    two = os.path.join(workdir, "two_ranks_run")
    os.makedirs(two)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_dp_rank, args=(r, two)) for r in range(DP_RANKS)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=900)
    two_s = time.perf_counter() - t0
    for p in procs:
        if p.is_alive():
            p.terminate()
            p.join(30)
    codes = [p.exitcode for p in procs]
    if any(codes):
        for r in range(DP_RANKS):
            out = os.path.join(two, f"rank{r}.out")
            if os.path.exists(out):
                print(open(out).read()[-3000:], flush=True)
    check(not any(codes), f"dp: two gloo ranks exited with {codes}")
    outs = [torch.load(os.path.join(two, f"rank{r}.pt"), weights_only=False)
            for r in range(DP_RANKS)]
    digests = []
    for r in range(DP_RANKS):
        with open(os.path.join(two, "logs", f"dp_two_ranks_rank{r}.log")) as fh:
            digests.append(fh.read().split("parameter digest ")[1].split()[0])
    train_metrics = [{k: v for k, v in o["metrics"].items() if k.startswith("train/")}
                     for o in outs]
    x = torch.cat([o["frames"] for o in outs]).to(dev)
    ref = norm.rms_update(norm.RMSState(*(t.to(dev) for t in outs[0]["before"])), x)
    second = float(x.double().square().mean())
    mean_scale = float(x.double().abs().mean())
    pooled = []
    for o in outs:
        mean, var, count = (t.to(dev) for t in o["after"])
        pooled.append(dict(
            mean_err=float((mean - ref.mean).abs().max()),
            mean_tol=1e-6 * (float(ref.mean.abs().max()) + mean_scale),
            var_err=float((var - ref.var).abs().max()), var_tol=1e-6 * second,
            count=float(count), ref_count=float(ref.count)))
    pooled_ok = all(p["mean_err"] <= p["mean_tol"] and p["var_err"] <= p["var_tol"]
                    and p["count"] == p["ref_count"] for p in pooled)
    replicas_equal = len(set(digests)) == 1
    log("dp", nvidia_smi=gpu_name_power(), envs=NUM_ENVS, steps=NUM_STEP, epochs=EPOCH,
        mini_batch=MINI_BATCH, updates=updates,
        turns=[r["tag"] for r in runs], same_state_bits=same_state,
        same_metrics=same_metrics,
        group_of_one=dict(backend=one["backend"],
                          all_reduce_calls=[r["all_reduce_calls"] for r in runs
                                            if r["tag"] == "group_of_one"],
                          gradient_all_reduces=grad_reduces, gradient_all_reduce=reduce_cost,
                          launches=one["counts"],
                          expected_launches=expect,
                          train_s=[r["train_s"] for r in runs if r["tag"] == "group_of_one"],
                          frames_per_s=fps["group_of_one"]),
        without_group=dict(train_s=[r["train_s"] for r in runs if r["tag"] == "plain"],
                           frames_per_s=fps["plain"],
                           all_reduce_calls=[r["all_reduce_calls"] for r in runs
                                             if r["tag"] == "plain"]),
        two_gloo_ranks=dict(ranks=DP_RANKS, envs_per_rank=DP_RANK_ENVS,
                            devices=[o["device"] for o in outs],
                            backends=[o["backend"] for o in outs],
                            train_s=[o["train_s"] for o in outs], wall_s=two_s,
                            digests=digests, replicas_equal=replicas_equal,
                            train_metrics_equal=train_metrics[0] == train_metrics[1],
                            obs_rms_pooled=pooled))
    for r in runs:
        check_counts(r["counts"], expect, f"dp {r['tag']}: train")
        grouped = r["tag"] == "group_of_one"
        check(r["backend"] == ("nccl" if grouped else None),
              f"dp {r['tag']}: backend {r['backend']}")
        check(r["all_reduce_calls"] >= grad_reduces if grouped else r["all_reduce_calls"] == 0,
              f"dp {r['tag']}: {r['all_reduce_calls']} all-reduce calls")
    if train_launches is not None:
        check(all(one["counts"][k] == train_launches[k] for k in expect),
              f"dp: launches {one['counts']} against the train line's {train_launches}")
    check(same_state, "dp: a group of one changed the parameters, optimizer or normalisers")
    check(same_metrics, "dp: a group of one changed the metrics")
    check(replicas_equal, f"dp: the gloo ranks' parameters differ {digests}")
    check(train_metrics[0] == train_metrics[1], "dp: the ranks' pooled metrics differ")
    check(pooled_ok, f"dp: pooled obs_rms against one process's {pooled}")
    return one["counts"]


SOURCES = {  # kernel -> (csrc source, the TPU kernel's pallas_call)
    "flash_qkv_fwd": ("flash_qkv", "eavit_tpu/ops/flash_qkv.py:531"),
    "flash_qkv_bwd": ("flash_qkv_bwd", "eavit_tpu/ops/flash_qkv.py:580"),
    "flash_qkv_bits": ("flash_qkv", "eavit_tpu/ops/flash_qkv.py:715"),
    "fused_ffn_fwd": ("fused_ffn", "eavit_tpu/ops/fused_ffn.py:288"),
    "fused_ffn_bwd": ("fused_ffn_bwd", "eavit_tpu/ops/fused_ffn.py:321"),
    "fused_ffn_bits": ("fused_ffn", "eavit_tpu/ops/fused_ffn.py:455"),
    "flash_fwd": ("flash", "eavit_tpu/ops/flash.py:125"),
    "flash_bwd": ("flash", "eavit_tpu/ops/flash.py:217"),
    "flash_dropout_fwd": ("flash_dropout", "eavit_tpu/ops/flash_dropout.py:225"),
    "flash_dropout_bwd": ("flash_dropout", "eavit_tpu/ops/flash_dropout.py:254"),
    "flash_dropout_bits": ("flash_dropout", "eavit_tpu/ops/flash_dropout.py:349"),
    "flash_stream_fwd": ("flash_stream", "eavit_tpu/ops/flash_stream.py:159"),
    "flash_stream_dq": ("flash_stream", "eavit_tpu/ops/flash_stream.py:285"),
    "flash_stream_dkv": ("flash_stream", "eavit_tpu/ops/flash_stream.py:304"),
    "flash_qkv_fwd_stream": ("flash_qkv", "eavit_tpu/ops/flash_qkv.py:531"),
    "flash_qkv_bwd_stream": ("flash_qkv_bwd", "eavit_tpu/ops/flash_qkv.py:580"),
    "flash_bwd_stream": ("flash", "eavit_tpu/ops/flash.py:217"),
    "flash_dropout_bwd_stream": ("flash_dropout", "eavit_tpu/ops/flash_dropout.py:254"),
}


def kernel_entry(name, row, launches, **extra):
    src, replaces = SOURCES[name]
    return {"name": name, "route": "cuda", "source": f"eavit_tpu_torch/csrc/{src}.cu",
            "replaces": replaces, "launches": launches,
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "on_main_path": not name.endswith("_bits"), **extra}


def log_split(attention, timing, kernel_ms, counts_per_update):
    """The ``main_path`` line of one flagship iteration timed in pieces."""
    kernel_s = sum(counts_per_update[n] * ms for n, ms in kernel_ms.items()) / 1e3
    log("main_path", mode="shared", path="train", attention=attention, envs=NUM_ENVS,
        steps=NUM_STEP, frames=NUM_ENVS * NUM_STEP, epochs=EPOCH, mini_batch=MINI_BATCH,
        kernel_s_per_update=kernel_s, kernel_share_of_update=kernel_s / timing["update_s"],
        **timing)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU", file=sys.stderr)
        return 2
    try:
        from eavit_tpu_torch.ops import _build, kernel_prng
        from eavit_tpu_torch.ops import flash as fl
        from eavit_tpu_torch.ops import flash_dropout as fd
        from eavit_tpu_torch.ops import flash_qkv as fq
        from eavit_tpu_torch.ops import flash_stream as fs
        from eavit_tpu_torch.ops import fused_ffn as ff
    except ImportError as e:
        print(f"chip_smoke: run from the root of a checkout ({e})", file=sys.stderr)
        return 2
    mods = (fq, ff, fl, fd, fs)

    # comparisons in full float32: no TF32 in matmuls or cuDNN convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    only = sys.argv[sys.argv.index("--only") + 1] if "--only" in sys.argv else None
    check(only in (None, "dp"), f"--only {only}: the phases it takes are: dp")
    card = gpu_name_power()
    log("device", nvidia_smi=card, torch=torch.__version__, cuda=torch.version.cuda,
        name=torch.cuda.get_device_name(0), count=torch.cuda.device_count())

    t0 = time.perf_counter()
    _, build_log = _build.build_all()
    ptxas = [ln.strip() for ln in build_log.splitlines()
             if "Used" in ln or "Compiling entry" in ln]
    log("build", seconds=time.perf_counter() - t0, ptxas=ptxas)
    report = ptxas_report(build_log)
    mma = {name: mma_ptxas(report, src, kind) for name, src, kind in (
        ("flash_qkv_fwd", "flash_qkv.cu", "fwd"), ("flash_qkv_bwd", "flash_qkv_bwd.cu", "bwd"),
        ("flash_fwd", "flash.cu", "fwd"), ("flash_bwd", "flash.cu", "bwd"),
        ("flash_dropout_fwd", "flash_dropout.cu", "fwd"),
        ("flash_dropout_bwd", "flash_dropout.cu", "bwd"),
        ("flash_stream_fwd", "flash_stream.cu", "fwd"),
        ("flash_stream_bwd", "flash_stream.cu", "bwd"),
        ("fused_ffn_fwd", "fused_ffn.cu", "ffn"), ("fused_ffn_bwd", "fused_ffn_bwd.cu", "ffn"))}
    log("ptxas", kernels="tensor-core kernels (attn_fwd_mma.cuh, attn_bwd_mma.cuh, "
        "their whole-head forms attn_fwd_head.cuh, attn_bwd_head.cuh, fused_ffn.cu and "
        "fused_ffn_bwd.cu)", **mma)
    if build_log:  # empty when a build directory without its log was reused
        check(all(mma.values()), "ptxas reported no tensor-core kernel")
        # every kernel at Dh <= 32; K5f (one sweep), K2f and K2b at every Dh and dtype
        spills = {f"{k} {v}": i for k, d in mma.items() for v, i in d.items()
                  if (k in ("flash_stream_fwd", "fused_ffn_fwd", "fused_ffn_bwd")
                      or int(re.match(r"Dh(\d+)", v).group(1)) <= 32)
                  and (i.get("spill_stores") or i.get("spill_loads"))}
        check(not spills, f"tensor-core kernels spill: {spills}")
    if only == "dp":
        with tempfile.TemporaryDirectory() as workdir:
            dp_phase(torch, mods, dev, os.path.join(workdir, "dp"))
        print(card, flush=True)
        print(json.dumps({"ok": True, "only": only}), flush=True)
        return 0

    rows = kernel_phase(torch, fq, ff, kernel_prng, dev)
    rows.update(train_kernel_phase(torch, fq, ff, dev))
    rows.update(flash_kernel_phase(torch, fl, fd, fq, kernel_prng, dev))
    rows.update(stream_kernel_phase(torch, fs, fl, dev))
    cancellation_check(torch, fq, fd, fl, fs, dev)
    widths_phase(torch, ff, fq, fl, fd, fs, dev)
    stream_rows = stream_flagship_phase(torch, fq, fl, fd, dev)
    long_rows = long_n_phase(torch, fq, fl, fd, dev)
    from eavit_tpu_torch.rl.agent import RNDAgent

    item5_rows = item5_kernel_shapes(torch, fq, ff, kernel_prng, dev, RNDAgent.feature_chunk)
    act_launches = main_path(torch, mods, dev, shared=True)
    main_path(torch, mods, dev, shared=False)
    pallas_act = main_path(torch, mods, dev, shared=True, attention="pallas")
    main_path(torch, mods, dev, shared=False, attention="pallas")
    stream_act = main_path(torch, mods, dev, shared=True, attention="pallas_stream")
    main_path(torch, mods, dev, shared=False, attention="pallas_stream")

    for attention in ("pallas_qkv", "pallas", "pallas_stream"):
        grad_check(torch, dev, "float32", 2e-3, attention)   # other sum orders only
        grad_check(torch, dev, "bfloat16", 5e-2, attention)  # bf16 Dense layers
    determinism_phase(torch, mods, dev)
    with tempfile.TemporaryDirectory() as workdir:
        def run(tag, **kw):
            return training_path(torch, mods, dev, workdir=os.path.join(workdir, tag), **kw)

        train_launches, timing = run("qkv", shared=True, epochs=EPOCH, updates=2,
                                     pieces=True)
        run("qkv_stacked", shared=False, epochs=1, updates=1)
        pallas_launches, pallas_timing = run("pallas", shared=True, epochs=EPOCH,
                                             updates=1, attention="pallas", pieces=True)
        run("pallas_stacked", shared=False, epochs=1, updates=1, attention="pallas")
        zero_launches, _ = run("pallas_dropout0", shared=True, epochs=1, updates=1,
                               attention="pallas", vit=dict(dropout=0.0))
        stream_launches, stream_timing = run("stream", shared=True, epochs=EPOCH, updates=1,
                                             attention="pallas_stream", pieces=True)
        run("stream_stacked", shared=False, epochs=1, updates=1, attention="pallas_stream")
        # patch 4: N = 443, a whole iteration on the streaming kernels (the
        # other routes take one minibatch step below)
        run("stream_patch4", shared=True, epochs=1, updates=1, attention="pallas_stream",
            vit=dict(patch_size=4))
        device_env_phase(torch, mods, dev, os.path.join(workdir, "device_env"), timing)
        continuous_launches = continuous_phase(torch, mods, dev)
        modified_launches = modified_rnd_phase(torch, mods, dev,
                                               os.path.join(workdir, "modified_rnd"),
                                               item5_rows)
        ssl_launches = {m: ssl_phase(torch, mods, dev, os.path.join(workdir, f"ssl_{m}"), m,
                                     timing) for m in SSL_METHODS}
        dp_launches = dp_phase(torch, mods, dev, os.path.join(workdir, "dp"), train_launches)
    remat_rows = remat_phase(torch, mods, dev)
    route_launches = patch4_other_routes(torch, mods, dev)
    collectors = device_rollout_phase(torch, mods, dev)
    # K1f and K2f at the pipelined collector's half act (32 frames)
    half_rows = k1f_rows(torch, fq, dev, "half_act", NUM_ENVS // 2, 198, 2, (0.0, 0.1))
    half_rows.update(k2f_rows(torch, ff, kernel_prng, dev, NUM_ENVS // 2 * 198,
                              (torch.float32,), (0.0, 0.1)))
    with tempfile.TemporaryDirectory() as workdir:
        hg = hg_phase(torch, mods, dev, workdir)

    # the kernels of the flagship iteration (shared stream): launch counts of
    # the training runs that use them, times at the acting shape ("ms" of the
    # forward kernels, which run there too) and at the minibatch shape
    def train_ms(name, use="train", n=198, key="ms"):
        return rows[(name, use, n, "bfloat16")][key]

    def item5_fields(name):
        """Launches of ``name`` in the continuous and modified_RND runs and,
        for K1f and K2f, their rows at the next-obs pass's and the
        1,024-frame minibatch's shapes."""
        out = {"continuous_launches_per_rollout": continuous_launches["collect"][name],
               "continuous_launches_per_update": continuous_launches["update"][name],
               "modified_rnd_train_launches": modified_launches[name]}
        for use in ("next_obs", "train_mb1024"):
            row = item5_rows.get((name, use))
            if row:
                shape = ({"b": row["b"], "n": row["n"]} if "b" in row else {"rows": row["rows"]})
                out[f"{use}_shape"] = {**shape, "rate": row["rate"], "dtype": row["dtype"],
                                       **{k: row[k] for k in (
                                           "ms", "plain_ms", "bound_ms", "bound_by",
                                           "library_ms", "max_abs_err", "tol")}}
        return out

    k1f_train = rows[("flash_qkv_fwd", "train", 198, 0.1)]
    k2f_act = rows[("fused_ffn_fwd", NUM_ENVS * 198, "float32", 0.1)]
    k2f_train = rows[("fused_ffn_fwd", MB_FRAMES * 198, "float32", 0.1)]
    launched = {"flash_fwd": zero_launches["flash_fwd"],
                "flash_dropout_fwd": pallas_launches["flash_dropout_fwd"]}
    kernels = [
        kernel_entry("flash_qkv_fwd", rows[("flash_qkv_fwd", "act", 198, 0.1)],
                     train_launches["flash_qkv_fwd"], header="attn_fwd_head.cuh",
                     ptxas=mma["flash_qkv_fwd"],
                     act_launches_per_rollout=act_launches["flash_qkv_fwd"],
                     train_shape_ms=k1f_train["ms"], train_shape_plain_ms=k1f_train["plain_ms"],
                     train_shape_bound_ms=k1f_train["bound_ms"],
                     train_shape_library_ms=k1f_train["library_ms"],
                     train_shape_rate0_ms=rows[("flash_qkv_fwd", "train", 198, 0.0)]["ms"],
                     **item5_fields("flash_qkv_fwd")),
        kernel_entry("flash_qkv_bwd", rows[("flash_qkv_bwd", 198, 0.1)],
                     train_launches["flash_qkv_bwd"], header="attn_bwd_head.cuh",
                     ptxas=mma["flash_qkv_bwd"], **item5_fields("flash_qkv_bwd")),
        kernel_entry("flash_qkv_bits", rows["flash_qkv_bits"], train_launches["flash_qkv_bits"]),
        kernel_entry("fused_ffn_fwd", k2f_act, train_launches["fused_ffn_fwd"],
                     header="fused_ffn.cu (mma.sync)", ptxas=mma["fused_ffn_fwd"],
                     smem_bytes={d: ff.fwd_smem_bytes(256, getattr(torch, d))
                                 for d in ("float32", "bfloat16")},
                     act_launches_per_rollout=act_launches["fused_ffn_fwd"],
                     cuda_core_bound_ms=k2f_act["cuda_core_bound_ms"],
                     chain_ms=k2f_act["chain_ms"], chain_bf16_ms=k2f_act["chain_bf16_ms"],
                     stacked_act_shape_ms=rows[("fused_ffn_fwd", 2 * NUM_ENVS * 197,
                                                "float32", 0.1)]["ms"],
                     bfloat16_act_shape_ms=rows[("fused_ffn_fwd", NUM_ENVS * 198, "bfloat16",
                                                 0.1)]["ms"],
                     **{f"train_shape_{key}": k2f_train[key] for key in (
                         "ms", "plain_ms", "bound_ms", "cuda_core_bound_ms", "chain_ms",
                         "chain_bf16_ms")},
                     bfloat16_train_shape_ms=rows[("fused_ffn_fwd", MB_FRAMES * 198,
                                                   "bfloat16", 0.1)]["ms"],
                     **item5_fields("fused_ffn_fwd")),
        kernel_entry("fused_ffn_bwd", rows[("fused_ffn_bwd", MB_FRAMES * 198, "float32", 0.1)],
                     train_launches["fused_ffn_bwd"], header="fused_ffn_bwd.cu (mma.sync)",
                     ptxas=mma["fused_ffn_bwd"],
                     cuda_core_bound_ms=rows[("fused_ffn_bwd", MB_FRAMES * 198, "float32",
                                              0.1)]["cuda_core_bound_ms"],
                     stacked_train_shape_ms=rows[("fused_ffn_bwd", 2 * MB_FRAMES * 197,
                                                  "float32", 0.1)]["ms"],
                     **{k: rows[("fused_ffn_bwd", MB_FRAMES * 198, "float32", 0.1)][k]
                        for k in ("chain_bwd_ms", "chain_bwd_bf16_ms")},
                     bfloat16_train_shape_ms=rows[("fused_ffn_bwd", MB_FRAMES * 198,
                                                   "bfloat16", 0.1)]["ms"],
                     **item5_fields("fused_ffn_bwd")),
        kernel_entry("fused_ffn_bits", rows["fused_ffn_bits"], train_launches["fused_ffn_bits"]),
        # K4 runs on the pallas route at dropout 0 (and in evaluate); K3 while
        # dropout is live
        *(kernel_entry(name, rows[(name, "act", 198, "bfloat16")], launched[name],
                       header="attn_fwd_mma.cuh", ptxas=mma[name],
                       train_shape_ms=train_ms(name),
                       train_shape_library_ms=train_ms(name, key="library_ms"),
                       train_shape_bound_ms=train_ms(name, key="bound_ms"),
                       stacked_train_shape_ms=train_ms(name, n=197),
                       **({"act_launches_per_rollout": pallas_act[name]}
                          if name == "flash_dropout_fwd" else {}))
          for name in ("flash_fwd", "flash_dropout_fwd")),
        kernel_entry("flash_bwd", rows[("flash_bwd", "train", 198, "bfloat16")],
                     zero_launches["flash_bwd"], header="attn_bwd_head.cuh",
                     ptxas=mma["flash_bwd"],
                     stacked_train_shape_ms=train_ms("flash_bwd", n=197)),
        kernel_entry("flash_dropout_bwd", rows[("flash_dropout_bwd", "train", 198, "bfloat16")],
                     pallas_launches["flash_dropout_bwd"], header="attn_bwd_head.cuh",
                     ptxas=mma["flash_dropout_bwd"]),
        kernel_entry("flash_dropout_bits", rows["flash_dropout_bits"],
                     pallas_launches["flash_dropout_bits"]),
        # K5 on pallas_stream: bf16 K5f on the one-sweep tensor-core forward,
        # beside SDPA's forward and K4f (the same template's two sweeps, the
        # same function at rate 0); bf16 K5q and K5kv on the tensor-core
        # backward, SDPA's backward (dq, dk and dv at once) beside them
        # together; every float32 K5 kernel on the CUDA-core template
        kernel_entry("flash_stream_fwd", rows[("flash_stream_fwd", "act", 198, "bfloat16")],
                     stream_launches["flash_stream_fwd"],
                     header="attn_fwd_mma.cuh (one sweep)", ptxas=mma["flash_stream_fwd"],
                     act_launches_per_rollout=stream_act["flash_stream_fwd"],
                     k4f_act_shape_ms=rows[("flash_stream_fwd", "act", 198, "bfloat16")][
                         "k4_fwd_ms"],
                     **{f"{tag}_{key}": rows[("flash_stream_fwd", use, n, "bfloat16")][col]
                        for tag, use, n in (("train_shape", "train", 198),
                                            ("stacked_train_shape", "train", 197),
                                            ("patch4_train_shape", "train_patch4", 443),
                                            ("n3137_dh64", "long", 3137))
                        for key, col in (("ms", "ms"), ("library_ms", "library_ms"),
                                         ("k4f_ms", "k4_fwd_ms"), ("bound_ms", "bound_ms"))},
                     float32_header="flash_stream.cuh",
                     float32_act_shape_ms=rows[("flash_stream_fwd", "act", 198, "float32")][
                         "ms"]),
        *(kernel_entry(name, rows[(name, "train", 198, "bfloat16")], stream_launches[name],
                       header="attn_bwd_mma.cuh",
                       ptxas={k: v for k, v in mma["flash_stream_bwd"].items()
                              if k.split()[1] == name.rsplit("_", 1)[1]},
                       library_is="SDPA backward: dq, dk and dv",
                       stacked_train_shape_ms=train_ms(name, n=197),
                       patch4_train_shape_ms=train_ms(name, "train_patch4", 443),
                       float32_header="flash_stream.cuh",
                       float32_act_shape_ms=rows[(name, "act", 198, "float32")]["ms"],
                       k4b_stream_train_shape_ms=train_ms(name, key="k4_bwd_stream_ms"))
          for name in ("flash_stream_dq", "flash_stream_dkv")),
    ]
    # the streaming kernels beside the whole-head ones: their launches come
    # from the long-sequence minibatch steps (patch 3 in bf16, patch 4 in
    # float32), their times from the flagship shapes (K1f at the act shape)
    stream_header = {"flash_qkv_fwd_stream": ("attn_fwd_mma.cuh", "flash_qkv_fwd")}
    for name, use, rate in (("flash_qkv_fwd_stream", "act", 0.1),
                            ("flash_qkv_bwd_stream", "train", 0.1),
                            ("flash_bwd_stream", "train", 0.0),
                            ("flash_dropout_bwd_stream", "train", 0.1)):
        header, of = stream_header.get(name, ("attn_bwd_mma.cuh", name.removesuffix("_stream")))
        extra = {"train_shape_ms": stream_rows[(name, "train", 0.1)]["ms"],
                 "train_shape_rate0_ms": stream_rows[(name, "train", 0.0)]["ms"],
                 "train_shape_library_ms": stream_rows[(name, "train", 0.1)]["library_ms"]} \
            if name == "flash_qkv_fwd_stream" else {}
        if name == "flash_qkv_bwd_stream":
            extra = {"rate0_ms": stream_rows[(name, "train", 0.0)]["ms"]}
        if name in ("flash_bwd_stream", "flash_dropout_bwd_stream"):  # patch 4 runs these
            extra = {"patch4_train_shape_ms": train_ms(of, "train_patch4", 443)}
        kernels.append(kernel_entry(name, stream_rows[(name, use, rate)],
                                    route_launches.get(name, 0), header=header,
                                    ptxas=mma[of], launches_from="long-sequence minibatch steps",
                                    **extra))
    for entry in kernels:  # K1, K3 and K4 at the long sequences, bf16 and float32
        key = entry["name"]  # the streaming kernels' own rows
        if (key, LONG_N[0], "bfloat16") in long_rows:
            entry["long_n_ms"] = {f"{d} N={n}": long_rows[(key, n, d)]["ms"]
                                  for n in LONG_N for d in ("bfloat16", "float32")}
    for entry in kernels:  # the SSL runs', the remat steps' and the dp run's launches
        key = entry["name"]
        if key in ("flash_qkv_fwd", "flash_qkv_bwd", "fused_ffn_fwd", "fused_ffn_bwd"):
            entry["dp_group_of_one_launches"] = dp_launches[key]
        if key in ssl_launches["byol"]:
            entry.update({f"ssl_{m}_train_launches": ssl_launches[m][key] for m in SSL_METHODS})
        route = "pallas_qkv" if key.startswith(("flash_qkv", "fused_ffn")) else "pallas"
        if f"{route} none" in remat_rows and key in remat_rows[f"{route} none"]["launches"] \
                and not key.endswith("_bits"):
            entry["remat_step_launches"] = {mode: remat_rows[f"{route} {mode}"]["launches"][key]
                                            for mode in ("none", "full", "dots")}
    by_name = {k["name"]: k for k in kernels}

    def shape_fields(row):
        return {k: row[k] for k in ("b", "rows", "n", "dim", "hidden", "heads", "dim_head",
                                    "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                    "chain_ms", "chain_bf16_ms", "chain_bwd_ms",
                                    "chain_bwd_bf16_ms", "max_abs_err", "tol", "max_rel_err",
                                    "fused", "launched") if k in row}

    # the HF flavour's shapes, launches and steps, and the pipelined
    # collector's half act, beside each kernel's flagship numbers
    hg_rows, n_hg = hg["rows"], hg["tokens"]
    rates, both = (0.0, 0.1), ("float32", "bfloat16")
    extra = {
        "flash_qkv_fwd": {f"hg_{use}_shape": {
            f"rate {r}": shape_fields(hg_rows[("flash_qkv_fwd", f"hg_{use}", n_hg, r)])
            for r in rates} for use in ("act", "train")},
        "flash_qkv_bwd": {"hg_train_shape": {
            f"rate {r}": shape_fields(hg_rows[("flash_qkv_bwd", n_hg, r)]) for r in rates}},
        "fused_ffn_fwd": {f"hg_{use}_shape": {
            f"{d} rate {r}": shape_fields(hg_rows[("fused_ffn_fwd", f * n_hg, d, r)])
            for d in both for r in rates}
            for use, f in (("act", NUM_ENVS), ("train", MB_FRAMES))},
        "fused_ffn_bwd": {"hg_train_shape": {
            f"{d} rate {r}": shape_fields(hg_rows[("fused_ffn_bwd", MB_FRAMES * n_hg, d, r)])
            for d in both for r in rates}},
    }
    for name in ("fused_ffn_fwd", "fused_ffn_bwd"):
        extra[name]["hg_path_dtype"] = hg["ffn_dtype"]
    for attention, step in hg["steps"].items():
        for name, count in step["launches"].items():
            if count:
                extra.setdefault(name, {})[f"hg_{attention}_step"] = dict(
                    launches=count, step_ms=step["step_ms"],
                    device_ms_per_step=step["device_ms_per_step"])
    for name in ("flash_qkv_fwd", "fused_ffn_fwd"):
        extra[name]["half_act_shape"] = {
            f"rate {r}": shape_fields(half_rows[(name, "half_act", 198, r)] if name ==
                                      "flash_qkv_fwd" else half_rows[(
                                          name, NUM_ENVS // 2 * 198, "float32", r)])
            for r in rates}
        extra[name]["device_pipelined_launches_per_rollout"] = \
            collectors["device_pipelined"]["launches"][name]
    for entry in kernels:
        name = entry["name"]
        entry.update(extra.get(name, {}))
        for key, counts in (("hg_launches_per_rollout", hg["timing"]["launches_per_rollout"]),
                            ("hg_launches_per_update", hg["timing"]["launches_per_update"])):
            if counts.get(name):
                entry[key] = counts[name]
    log_split("pallas_qkv", timing, {n: by_name[n].get("train_shape_ms", by_name[n]["ms"])
                                     for n in ("flash_qkv_fwd", "fused_ffn_fwd",
                                               "flash_qkv_bwd", "fused_ffn_bwd")},
              timing["launches_per_update"])
    log_split("pallas", pallas_timing,
              {n: by_name[n].get("train_shape_ms", by_name[n]["ms"])
               for n in ("flash_dropout_fwd", "fused_ffn_fwd", "flash_dropout_bwd",
                         "fused_ffn_bwd")},
              pallas_timing["launches_per_update"])
    log_split("pallas_stream", stream_timing,
              {n: by_name[n].get("train_shape_ms", by_name[n]["ms"])
               for n in ("flash_stream_fwd", "fused_ffn_fwd", "flash_stream_dq",
                         "flash_stream_dkv", "fused_ffn_bwd")},
              stream_timing["launches_per_update"])
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
