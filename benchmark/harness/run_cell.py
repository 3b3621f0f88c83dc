"""One run of a cell: set-up with the first iteration observed, the timed
window, the traced iteration, then the reference's judgement.

:func:`run` is what ``benchmark/run.py`` calls on the card; the tests call
it on the CPU at a tiny size, and ``benchmark/calibrate.py`` calls its
pieces to read the limits of the correctness numbers.
"""

from __future__ import annotations

import gc
import sys
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from benchmark.harness import correct, spec
from benchmark.harness.cell import Job, Spans, rollout_capture
from benchmark.harness.trace import Trace, from_profiler
from benchmark.reference import model as ref_model
from benchmark.reference.follow import follow
from benchmark.reference.weights import make_weights

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "eavit_tpu")


@dataclass
class RunData:
    """What the metric readers read (``metrics/*.py``)."""

    frames: float = 0.0
    window_s: float = 0.0
    iterations: int = 0
    frames_per_iteration: int = 0
    spans: List[Dict[str, float]] = field(default_factory=list)
    trace: Optional[Trace] = None
    groups: Dict[str, Any] = field(default_factory=dict)
    work: Dict[str, Tuple[float, float]] = field(default_factory=dict)
    model_flops: float = 0.0
    peak_bytes: int = 0
    setup_s: float = 0.0
    hp: Dict[str, Any] = field(default_factory=dict)


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


# -- faults that the checks must catch (calibrate.py and the tests) ---------

def plant(job: Job, fault: Optional[str]) -> None:
    """Break the program's first iteration underneath the benchmark."""
    if fault is None:
        return
    agent = job.agent
    if fault == "frozen_step":  # a step that returns its state unchanged
        agent.optimizer.step = lambda *a, **k: None
    elif fault == "half_batch":  # half the minibatch left out, the mean over the rest
        orig = agent._minibatch_step

        def half(batch, idx, rng, params):
            return orig(batch, idx[: idx.shape[0] // 2], rng, params)

        agent._minibatch_step = half
    elif fault == "altered_action":  # one answer altered where it is produced
        orig_act, calls = agent.act, [0]

        def act(*a, **k):
            out = orig_act(*a, **k)
            calls[0] += 1
            if calls[0] == 6:
                actions = out[0].clone()
                actions[0] = (actions[0] + 1) % agent.output_size
                out = (actions,) + tuple(out[1:])
            return out

        agent.act = act
    else:
        raise ValueError(f"unknown fault {fault!r}")


def first_iteration(cell: Dict[str, Any], seed: int, device, fault: Optional[str] = None,
                    log: Callable[[str], None] = lambda s: None) -> Tuple[Job, Dict[str, Any]]:
    """Build the job and run its warm-up and first iteration under
    observation (and a planted fault, if any)."""
    t = time.perf_counter()
    job = Job(cell, seed, device)
    job.build()
    cap, remove = rollout_capture(job)
    _sync(device)
    t_built = time.perf_counter()
    job.warm_up_obs_norm()
    cap["armed"] = True
    plant(job, fault)
    _sync(device)
    t_warm = time.perf_counter()
    job.iterate()
    remove()
    log(f"set-up: build {t_built - t:.2f} s, obs-norm warm-up {t_warm - t_built:.2f} s, "
        f"first iteration {time.perf_counter() - t_warm:.2f} s")
    for obj, name in ((job.agent, "_minibatch_step"), (job.agent, "act")):
        obj.__dict__.pop(name, None)
    job.agent.optimizer.__dict__.pop("step", None)
    return job, cap


def reference_side(hp: Dict[str, Any], seed: int, cap: Dict[str, Any], device,
                   lower: bool = False) -> Dict[str, Any]:
    """The reference's (or, ``lower``, the control's) first iteration."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        weights = make_weights(ref_model.leaf_specs(hp), seed, device)
        return follow(dict(hp, rng_seed=seed + 1), weights, cap, device, lower=lower)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def release(job: Job, device) -> None:
    job.close()
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def _launches() -> Dict[str, int]:
    from eavit_tpu_torch.ops import flash, flash_dropout, flash_qkv, flash_stream, fused_ffn

    return {k: v for m in (flash, flash_dropout, flash_qkv, flash_stream, fused_ffn)
            for k, v in m.launches.items()}


def _reset_launches() -> None:
    from eavit_tpu_torch.ops import flash, flash_dropout, flash_qkv, flash_stream, fused_ffn

    for m in (flash, flash_dropout, flash_qkv, flash_stream, fused_ffn):
        m.reset_launches()


def run(cell: Dict[str, Any], seed: int, seconds: float, trace: bool, device,
        t0: float, log: Callable[[str], None], fault: Optional[str] = None) -> Dict[str, Any]:
    """One run of ``cell``; returns the result line's fields (without
    printing it). ``fault`` breaks the program underneath (the tests)."""
    log(f"imports {time.perf_counter() - t0:.2f} s")
    job, cap = first_iteration(cell, seed, device, fault, log)
    hp, dev = job.hp, torch.device(device)
    _sync(dev)
    data = RunData(hp=hp, groups=spec.kernel_groups(),
                   frames_per_iteration=job.frames_per_iteration())
    data.setup_s = time.perf_counter() - t0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    spans = Spans(sync=trace)
    start = last = time.perf_counter()
    each = []
    while True:
        job.iterate(spans if trace else None)
        data.iterations += 1
        now = time.perf_counter()
        each.append(now - last)
        last = now
        if now - start >= seconds:
            break
    _sync(dev)
    data.window_s = time.perf_counter() - start
    log(f"window: {data.iterations} iterations in {data.window_s:.3f} s, each "
        + " ".join(f"{t:.3f}" for t in each))
    data.frames = float(data.frames_per_iteration * data.iterations)
    data.spans = spans.rows
    data.peak_bytes = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    arch = spec.work_model(hp["arch"])
    from benchmark.work import ppo_rnd

    data.work = ppo_rnd.iteration(arch, hp)
    data.model_flops = ppo_rnd.model_flops(arch, hp)
    launches = None
    if trace:
        _reset_launches()
        activities = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=activities) as prof:
            job.iterate()
            _sync(dev)
        launches = _launches()
        data.trace = from_profiler(prof)
        del prof
    release(job, dev)

    t_ref = time.perf_counter()
    ref = reference_side(hp, seed, cap, dev)
    nums = correct.numbers(cap, ref, cap["actions"])
    log(f"reference {time.perf_counter() - t_ref:.2f} s")
    limits = cell["limits"]
    if launches is not None:
        calls = ppo_rnd.calls(hp)
        log(f"launches in the traced iteration: {launches}; the work model assumes {calls}")
    return {"data": data, "numbers": nums, "limits": limits,
            "correct": correct.judge(nums, limits), "launches": launches}
