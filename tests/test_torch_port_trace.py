"""The port's host spans (``eavit_tpu_torch/utils/trace.py``) on the CPU.

- With no profiler recording, ``span`` returns one shared no-op context and
  opens no profiler range.
- Under ``torch.profiler.profile``, one ``train.iteration`` of a tiny job on
  each collector (the host fleet serial and pipelined, ``RolloutCollector``,
  the device env) records the tree the module docstring draws: each span
  under its parent, ``T + 1`` acts, ``T`` env steps, ``Epoch x MiniBatch``
  minibatch steps each with its four children, no ``eavit.act_sync`` on the
  device env; Adam's step lies under ``eavit.optimizer`` and the autograd
  engine's work under ``eavit.backward``.
- Every name starts with ``eavit.`` and none is one of the benchmark's own
  annotations; the benchmark's trace reader keeps the spans as host
  intervals, out of the device intervals, and its window where its own
  annotations put it.
- The rollout and the update are bit-equal with and without a profiler
  recording.
"""

import collections
import contextlib
import fnmatch
import pathlib
import re

import numpy as np
import pytest
import torch

from benchmark.harness import trace as bench_trace
from eavit_tpu_torch import config as port_config
from eavit_tpu_torch import train as port_train
from eavit_tpu_torch.envs.device_env import make_device_env
from eavit_tpu_torch.envs.synthetic import SyntheticVectorEnv
from eavit_tpu_torch.models.layers import Rng
from eavit_tpu_torch.rl.agent import RNDAgent
from eavit_tpu_torch.rl.device_rollout import DeviceRolloutCollector
from eavit_tpu_torch.rl.rollout import RolloutCollector
from eavit_tpu_torch.rl.scan_rollout import ScanRolloutCollector
from eavit_tpu_torch.utils import trace as port_trace

torch.set_num_threads(1)

VIT = dict(dim=32, patch_size=21, depth=1, heads=2, dim_head=16, mlp_dim=64)
N_ENV, N_STEP, EPOCH, MINI_BATCH = 4, 6, 2, 2
KINDS = ("serial", "pipelined", "plain", "device")


def _documented_tree():
    """``{span: parent}`` from the module docstring's drawing, by indent."""
    tree, stack = {}, []
    for line in port_trace.__doc__.splitlines():
        m = re.match(r"^( +)(eavit\.\w+) ", line)
        if not m:
            continue
        depth = len(m.group(1))
        while stack and stack[-1][0] >= depth:
            stack.pop()
        tree[m.group(2)] = stack[-1][1] if stack else None
        stack.append((depth, m.group(2)))
    return tree


def _job(kind):
    """A tiny job on the collector ``kind``: (collector, agent, state, env
    state, rng)."""
    device_env = kind == "device"
    cfg = port_config.Config(
        vit=port_config.ViTConfig(**VIT), attention_impl="pallas_qkv", fused_ffn=True,
        num_env_per_process=N_ENV, num_step=N_STEP, compute_dtype="float32",
        shared_patch_stream=True, epoch=EPOCH, mini_batch=MINI_BATCH, obs_norm_step=1,
        max_step_per_episode=4, async_env_pool=kind == "pipelined",
        env_type="synthetic_device" if device_env else "synthetic", synthetic_grid=4)
    agent = RNDAgent(cfg, 5, device="cpu")
    state = agent.init_state(0)
    rng = Rng(1, agent.device)
    if device_env:
        params, env_state = make_device_env(
            N_ENV, seed=2, grid=cfg.synthetic_grid, height=cfg.pre_proc_height,
            width=cfg.pre_proc_width, max_episode_steps=cfg.max_step_per_episode,
            device=agent.device)
        return ScanRolloutCollector(cfg, agent, params), agent, state, env_state, rng
    env = SyntheticVectorEnv(N_ENV, seed=2, max_episode_steps=cfg.max_step_per_episode)
    make = RolloutCollector if kind == "plain" else DeviceRolloutCollector
    collector = make(cfg, agent, env)
    assert getattr(collector, "pipelined", False) == (kind == "pipelined")
    return collector, agent, state, env.reset(), rng


def _profile():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def _eavit_spans(prof):
    return [bench_trace.Interval(e.name(), e.start_ns(), e.end_ns())
            for e in prof.profiler.kineto_results.events() if e.name().startswith("eavit.")]


def _parent(s, spans):
    """The innermost other span whose interval holds ``s``."""
    over = [p for p in spans if p is not s and p.start <= s.start and s.end <= p.end]
    return min(over, key=lambda p: p.end - p.start).name if over else None


def test_span_off_is_one_shared_no_op(monkeypatch):
    assert not torch.autograd.profiler._is_profiler_enabled

    def record_function(name):
        raise AssertionError(f"span {name!r} opened a profiler range with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", record_function)
    a, b = port_trace.span("eavit.act"), port_trace.span("eavit.update")
    assert a is b and isinstance(a, contextlib.nullcontext)
    with a, b:  # shared, and nestable in itself
        pass


def test_span_on_is_a_profiler_range():
    with _profile() as prof:
        assert torch.autograd.profiler._is_profiler_enabled
        with port_trace.span("eavit.update"):
            with port_trace.span("eavit.minibatch"):
                torch.ones(2).add_(1)
    assert not torch.autograd.profiler._is_profiler_enabled
    events = {e.name(): e for e in prof.profiler.kineto_results.events()}
    for name in ("eavit.update", "eavit.minibatch"):
        assert events[name].is_user_annotation() and events[name].device_type().name == "CPU"
    spans = _eavit_spans(prof)
    (inner,) = [s for s in spans if s.name == "eavit.minibatch"]
    assert _parent(inner, spans) == "eavit.update"


def test_names_are_the_programs_own():
    tree = _documented_tree()
    assert len(tree) == 13 and tree["eavit.iteration"] is None
    for name in tree:
        assert name.startswith("eavit.") and name not in bench_trace.SPANS
    # every span the package opens is one the docstring draws, and the reverse
    package = pathlib.Path(port_train.__file__).parent
    opened = {n for f in package.rglob("*.py")
              for n in re.findall(r"\bspan\(\"([^\"]+)\"\)", f.read_text())}
    assert opened == set(tree)


@pytest.mark.parametrize("kind", KINDS)
def test_one_iteration_records_the_documented_tree(kind):
    collector, agent, state, env_state, rng = _job(kind)
    with _profile() as prof:
        port_train.iteration(collector, agent, state, env_state, rng)
    spans = _eavit_spans(prof)
    tree = _documented_tree()
    for s in spans:
        assert s.name in tree, s.name
        assert _parent(s, spans) == tree[s.name], (s.name, _parent(s, spans))
    count = collections.Counter(s.name for s in spans)
    n_mb = EPOCH * MINI_BATCH
    want = {"eavit.iteration": 1, "eavit.collect": 1, "eavit.act": N_STEP + 1,
            "eavit.env_step": N_STEP, "eavit.update": 1, "eavit.prepare_batch": 1,
            "eavit.minibatch": n_mb, "eavit.forward": n_mb, "eavit.backward": n_mb,
            "eavit.allreduce": n_mb, "eavit.optimizer": n_mb, "eavit.readback": 1}
    if kind == "pipelined":  # one act a lane a step, and the two bootstrap acts
        want.update({"eavit.act": 2 * (N_STEP + 1), "eavit.env_step": 2 * N_STEP})
    if kind != "device":
        want["eavit.act_sync"] = want["eavit.env_step"]
    assert dict(count) == want
    for mb in (s for s in spans if s.name == "eavit.minibatch"):
        children = sorted(s.name for s in spans if _parent(s, spans) == "eavit.minibatch"
                          and mb.start <= s.start and s.end <= mb.end)
        assert children == ["eavit.allreduce", "eavit.backward", "eavit.forward",
                            "eavit.optimizer"]
    # the work sits under its span: Adam's step, the autograd engine's backward
    ops = [(e.name(), e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()]
    for op, where in (("Optimizer.step#Adam.step", "eavit.optimizer"),
                      ("autograd::engine::evaluate_function: *", "eavit.backward")):
        found = [(s, e) for n, s, e in ops if fnmatch.fnmatchcase(n, op)]
        assert found and all(any(w.start <= s and e <= w.end for w in spans if w.name == where)
                             for s, e in found), op


def test_the_benchmark_reader_keeps_the_spans_on_the_host():
    collector, agent, state, states, rng = _job("serial")
    with _profile() as prof:
        with torch.profiler.record_function("collect"):
            rollout, states = collector.collect(states, rng)
        with torch.profiler.record_function("update"):
            state, metrics = agent.update(state, rollout, rng)
        with torch.profiler.record_function("readback"):
            {k: float(v) for k, v in metrics.items()}
    tr = bench_trace.from_profiler(prof)
    marks = {s.name: s for s in tr.spans}
    assert sorted(marks) == sorted(bench_trace.SPANS)
    assert tr.window == (marks["collect"].start, marks["readback"].end)
    assert not any(d.name.startswith("eavit.") for d in tr.device)
    ours = collections.Counter(h.name for h in tr.host if h.name.startswith("eavit."))
    assert ours["eavit.act"] == N_STEP + 1 and ours["eavit.minibatch"] == EPOCH * MINI_BATCH
    a, b = tr.window
    assert all(a <= h.start and h.end <= b for h in tr.host if h.name.startswith("eavit."))


def _outcome(kind, profiled):
    collector, agent, state, env_state, rng = _job(kind)
    with _profile() if profiled else contextlib.nullcontext():
        if kind == "device":
            rollout, env_state, _ = collector.collect(env_state, rng)
        else:
            rollout, env_state = collector.collect(env_state, rng)
        state, metrics = agent.update(state, rollout, rng)
    out = {f"rollout.{k}": v for k, v in rollout._asdict().items()}
    out.update({f"param.{n}": p for n, p in agent.network.named_parameters()})
    out.update({f"rnd.{n}": p for n, p in agent.rnd_pred.named_parameters()})
    out.update({k: v for k, v in metrics.items() if isinstance(v, torch.Tensor)})
    out["obs_rms.mean"] = state.obs_rms.mean
    return {k: v.detach().cpu().numpy() for k, v in out.items()}


@pytest.mark.parametrize("kind", ["serial", "device"])
def test_profiling_changes_no_bit(kind):
    plain, profiled = _outcome(kind, False), _outcome(kind, True)
    assert plain.keys() == profiled.keys()
    for k in plain:
        np.testing.assert_array_equal(plain[k], profiled[k], err_msg=k)
