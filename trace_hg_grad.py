#!/usr/bin/env python3
"""How far the HF flavour's bf16 gradient on the card lies from its copy on
the CPU, by depth and by seed: the readings behind ``chip_smoke.py``'s
``HG_GRAD_CRITERIA``. Run from the root of a checkout on a machine with one
NVIDIA GPU and the CUDA toolkit:

    python3 trace_hg_grad.py [--depths 2 6 12] [--seeds 0 1 2]

For each depth (``chip_smoke.hg_cfg``: ``ViTHGConfig``'s widths, its layer
count set to the depth) and each seed (of the weights and of the 8 frames of
``chip_smoke.ssl_host_batch``) it computes the loss and the gradient of the
network and the RND predictor four ways, at dropout 0 and ``UpdateProportion
= 1`` as ``chip_smoke.noisy_grad_check`` does: bf16 and float32, each on the
card (the kernels) and on the CPU (their plain versions). One JSON line per
(depth, seed) gives the relative errors of the gradient:

- ``bf16_card_vs_cpu``: what the ``hg`` line holds to the bf16 criterion;
- ``bf16_cpu_vs_f32_cpu``: the CPU copy's own bf16 rounding;
- ``bf16_card_vs_f32_cpu``: the card's bf16 against the float32 copy;
- ``f32_card_vs_cpu``: float32 on the card against the CPU.

Seed 0 at depth 12 is the ``hg`` line's own reading. The last JSON line
gives, per depth, the largest and smallest ``bf16_card_vs_cpu`` and their
ratio to ``2^-9 * sqrt(2 * depth)``, the model the criterion rests on.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time
from collections import Counter


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--depths", type=int, nargs="+", default=[2, 6, 12])
    p.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    return p.parse_args(argv)


def grads(torch, cs, cfg, dtype: str, where, seed: int, host):
    """``(loss, flat gradient on the CPU)`` of an HG agent on ``where``."""
    from eavit_tpu_torch.rl.agent import RNDAgent

    agent = RNDAgent(cfg.replace(compute_dtype=dtype), 5, device=where)
    agent.init_state(seed)
    cs.freeze_noise(torch, [agent], seed + 11)
    loss, g, _ = cs.network_grads(torch, agent, host, ())
    flat = torch.cat([g[k].float().reshape(-1).cpu() for k in sorted(g)])
    return float(loss), flat


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("trace_hg_grad: no CUDA device; this script runs on a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke as cs
    from eavit_tpu_torch.ops import _build
    from eavit_tpu_torch.ops import flash_qkv as fq
    from eavit_tpu_torch.ops import fused_ffn as ff

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    _build.build_all()
    card = cs.gpu_name_power()
    cs.log("device", nvidia_smi=card, torch=torch.__version__, cuda=torch.version.cuda)

    base = cs.hg_cfg()
    base = base.replace(update_proportion=1.0,
                        vit=dataclasses.replace(base.vit, dropout=0.0, emb_dropout=0.0))
    _, dh, _, _, n = cs.hg_widths(base)
    t0 = time.perf_counter()
    by_depth = {}
    for depth in args.depths:
        cfg = base.replace(vit_hg=dataclasses.replace(
            base.vit_hg, hidden_dropout_prob=0.0, num_hidden_layers=depth))
        for seed in args.seeds:
            host = cs.ssl_host_batch(torch, 8, seed)
            cs._reset((fq, ff))
            out = {(dt, w): grads(torch, cs, cfg, dt, w, seed, host)
                   for dt in ("bfloat16", "float32") for w in (dev, "cpu")}
            expect = Counter({"fused_ffn_fwd": 2 * depth, "fused_ffn_bwd": 2 * depth})
            for dt in (torch.bfloat16, torch.float32):  # the two card runs
                expect[fq.fwd_kernel(n, dh, dt)] += depth
                expect[fq.bwd_kernel(n, dh, dt)] += depth
            cs.check_counts(cs._counts((fq, ff)), expect, f"depth {depth}, seed {seed}")
            rel = {
                "bf16_card_vs_cpu": cs._rel(torch, out["bfloat16", dev][1],
                                            out["bfloat16", "cpu"][1]),
                "bf16_cpu_vs_f32_cpu": cs._rel(torch, out["bfloat16", "cpu"][1],
                                               out["float32", "cpu"][1]),
                "bf16_card_vs_f32_cpu": cs._rel(torch, out["bfloat16", dev][1],
                                                out["float32", "cpu"][1]),
                "f32_card_vs_cpu": cs._rel(torch, out["float32", dev][1],
                                           out["float32", "cpu"][1]),
            }
            by_depth.setdefault(depth, []).append(rel["bf16_card_vs_cpu"])
            cs.log("hg_grad", depth=depth, seed=seed, **rel,
                   loss={f"{dt} {w}": v[0] for (dt, w), v in out.items()},
                   launches=cs._counts((fq, ff)))
    summary = {}
    for depth, vals in by_depth.items():
        model = 2.0 ** -9 * (2 * depth) ** 0.5
        summary[depth] = dict(max=max(vals), min=min(vals), model=model,
                              max_over_model=max(vals) / model,
                              min_over_model=min(vals) / model)
    cs.log("summary", seconds=time.perf_counter() - t0,
           criterion=cs.HG_GRAD_CRITERIA["bfloat16"], by_depth=summary)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
