"""Data parallelism in the torch port (``eavit_tpu_torch/parallel/dp.py``)
against ``eavit_tpu``'s ``DataParallelAgent`` and against itself.

Two gloo ranks, each a process of ``tests/_torch_dp_worker.py`` joined
through a ``file://`` store, take half of one rollout's envs and run one
``RNDAgent.update`` with the JAX per-shard permutations; ``eavit_tpu``'s
``DataParallelAgent`` on ``make_mesh(2)`` of the suite's virtual CPU devices
runs the same update on the whole rollout in this process. Float32, dropout
0, ``UpdateProportion = 1``, ``StableEps = 1e-3`` and the plain attention
and FFN (this slice adds no kernel; the kernel routes are held elsewhere),
the JAX trees drawn with numpy in the shapes of ``jax.eval_shape``. Checked:
every ``train/*`` and ``data/*`` metric (rtol 1e-4, atol 1e-5), the
normalisers and counters (1e-5), each rank's ``rewems`` slice (1e-5), the
parameters (atol 2e-5), and the two ranks' parameters bit-equal.

Then the port alone: ``rms_update`` over two ranks equals one process's over
the concatenated batch for ``[B, 1, H, W]`` pixels and ``[B, D]``
embeddings, and ``prepare_batch`` over two ranks gives the reward RMS and
``obs_rms`` of one process's on the whole rollout: the mean within 1e-6 of
itself, the variance within 1e-6 of the batch's second moment ``E[x^2]``
(both sides form it as ``sumsq / n - mean^2`` in float32, in other sum
orders, so it rounds at the scale of ``E[x^2]``), the count exactly; a gloo group of
one changes no bit of ``update``; ``torchrun --nproc_per_node 2 -m
eavit_tpu_torch --train --device cpu`` trains on the host env (bit-equal
replicas by their logged digests, disjoint fleet seeds, one checkpoint by
rank 0 with both ranks' ``rewems``, a resume that continues the update count)
and on the device env (``data/num_episodes`` summed over the ranks, every
rank's env bookkeeping in the checkpoint, a resume); a
``DataAxisSize`` that is not the number of ranks raises. Every process group
has a timeout and every process is joined with one.
"""

import json
import os
import pathlib
import pickle
import shlex
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import NamedSharding

from eavit_tpu import config as jax_config
from eavit_tpu.parallel.dp import DataParallelAgent, make_mesh
from eavit_tpu.rl import normalizer as jax_norm
from eavit_tpu.rl.agent import AgentState as JaxAgentState
from eavit_tpu.rl.agent import Rollout as JaxRollout
from eavit_tpu.rl.agent import global_step_value
from eavit_tpu_torch import config as port_config
from eavit_tpu_torch.convert import flax_tree_to_torch, load_jax_params
from eavit_tpu_torch.models.layers import Rng
from eavit_tpu_torch.parallel import dp
from eavit_tpu_torch.rl import normalizer as norm
from eavit_tpu_torch.rl.agent import RNDAgent, Rollout
from eavit_tpu_torch.train import train

# One intra-op thread: the suite runs several test processes on one host.
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
WORKER = REPO / "tests" / "_torch_dp_worker.py"
TIMEOUT = 240  # seconds for any spawned process
TOL = dict(rtol=1e-5, atol=1e-5)
METRIC_TOL = dict(rtol=1e-4, atol=1e-5)
MOMENT_RTOL = 1e-6
PARAM_ATOL = 2e-5
WORLD = 2
TINY = dict(dim=48, patch_size=12, depth=1, heads=4, dim_head=12, mlp_dim=96,
            dropout=0.0, emb_dropout=0.0)
N_ENV, N_STEP, N_ACT, EPOCHS = 4, 8, 5, 2
COMMON = dict(num_env_per_process=N_ENV, num_step=N_STEP, compute_dtype="float32",
              shared_patch_stream=True, obs_norm_step=1, update_proportion=1.0,
              learning_rate=1e-3, stable_eps=1e-3, attention_impl="xla", fused_ffn=False,
              epoch=EPOCHS, mini_batch=2, use_grad_clipping=True, max_grad_norm=0.5)


def _np(x):
    return np.asarray(x)


def _random_tree(shapes, seed: int):
    """A flax tree of the shapes of ``shapes``: kernels N(0, 1/fan_in),
    LayerNorm scales near 1, biases near 0, the rest N(0, 1)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name, shape = path[-1].key, s.shape
        if name == "kernel":
            x = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        elif name == "scale":
            x = 1.0 + 0.1 * rng.standard_normal(shape)
        elif name == "bias":
            x = 0.1 * rng.standard_normal(shape)
        else:
            x = rng.standard_normal(shape)
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _frames(rng, shape):
    """uint8 frames with a level per channel (white noise alone gives every
    frame nearly the same statistics)."""
    levels = rng.integers(0, 256, shape[:-2] + (1, 1))
    return np.clip(levels + rng.integers(-24, 25, shape), 0, 255).astype(np.uint8)


def _rollout(seed):
    rng = np.random.default_rng(seed)
    T, N = N_STEP, N_ENV
    return dict(
        states=_frames(rng, (T, N, 4, 84, 84)),
        actions=rng.integers(0, N_ACT, (T, N)).astype(np.int64),
        rewards=rng.choice([0.0, 1.0, 3.0], (T, N)).astype(np.float32),
        dones=rng.random((T, N)) < 0.2,
        next_obs=_frames(rng, (T, N, 1, 84, 84)),
        value_ext=rng.standard_normal((T + 1, N)).astype(np.float32),
        value_int=rng.standard_normal((T + 1, N)).astype(np.float32),
        policy=rng.standard_normal((T, N, N_ACT)).astype(np.float32),
    )


def _jax_permutations(key, epochs, n):
    """The permutations ``_update_impl`` draws in each shard (the key is
    replicated, so every shard draws the same; agent.py:573-586)."""
    perms = []
    for k in jax.random.split(key, epochs):
        k_perm, _ = jax.random.split(k)
        perms.append(_np(jax.random.permutation(k_perm, n)))
    return perms


def _spawn(args, cwd):
    env = dict(os.environ, PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    return subprocess.Popen(args, cwd=cwd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _chain(cmds, cwd):
    """``cmds`` one after the other, in one background shell."""
    return _spawn(["sh", "-c", " && ".join(shlex.join(c) for c in cmds)], cwd)


def _join(proc) -> str:
    try:
        out, _ = proc.communicate(timeout=TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, _ = proc.communicate()
        pytest.fail(f"timed out: {proc.args}\n{out[-3000:]}")
    assert proc.returncode == 0, out[-4000:]
    return out


# ---------------------------------------------------------------------------
# everything that runs in other processes starts at once
# ---------------------------------------------------------------------------


def _conf(tmp: pathlib.Path, name: str, **keys) -> str:
    """``configs/synthetic_demo.conf`` with ``keys`` set."""
    lines = []
    for line in (REPO / "configs" / "synthetic_demo.conf").read_text().splitlines():
        key = line.split("=")[0].strip()
        lines.append(f"{key} = {keys.pop(key)}" if key in keys else line)
    path = tmp / name
    path.write_text("\n".join(lines + [f"{k} = {v}" for k, v in keys.items()]) + "\n")
    return str(path)


DEVICE_ENV_KEYS = dict(EnvType="synthetic_device", NumStep=8, ObsNormStep=1, Epoch=1,
                       MiniBatch=2, SyntheticGrid=4, SyntheticMaze=True, MaxStepPerEpisode=6,
                       DataAxisSize=0)


def _torchrun(tmp, conf, tag, *extra):
    return [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc_per_node", str(WORLD), "-m",
            "eavit_tpu_torch", "--train", "--config_path", conf, "--device", "cpu",
            "--log_name", tag, "--save_model_path", str(tmp / f"ck_{tag}"), *extra]


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """The two update ranks and the two ``torchrun`` trainings, started
    together; the reference update's inputs."""
    tmp = tmp_path_factory.mktemp("dp")
    dpa = DataParallelAgent(jax_config.Config(vit=jax_config.ViTConfig(**TINY), **COMMON),
                            N_ACT, make_mesh(WORLD))
    shapes = jax.eval_shape(dpa.agent.init_state, jax.random.PRNGKey(0))
    params, rnd_target = _random_tree(shapes.params, 0), _random_tree(shapes.rnd_target, 1)
    rng = np.random.default_rng(5)
    key = jax.random.PRNGKey(9)
    inputs = dict(
        vit=TINY, cfg=COMMON, n_act=N_ACT, params=params, rnd_target=rnd_target,
        frames=_frames(rng, (16, 1, 84, 84)), rollout=_rollout(4),
        perms=_jax_permutations(key, EPOCHS, N_STEP * N_ENV // WORLD),
        moments={"pixels": (rng.normal(90.0, 40.0, (12, 1, 9, 7)).astype(np.float32),
                            (1, 9, 7)),
                 "embeddings": (rng.normal(0.5, 2.0, (12, 33)).astype(np.float32), (1, 33))})
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    ranks = [_spawn([sys.executable, str(WORKER), str(tmp / "inputs.pkl"), str(r),
                     str(WORLD), str(tmp / "store")], tmp) for r in range(WORLD)]
    # each training, then a resume from its checkpoint
    host_conf = _conf(tmp, "host.conf", DataAxisSize=2)
    host = _chain([_torchrun(tmp, host_conf, "host", "--debug_params", "--total_updates", "2"),
                   _torchrun(tmp, host_conf, "host_resumed", "--debug_params",
                             "--total_updates", "3", "--load_model_path",
                             str(tmp / "ck_host" / "host"))], tmp)
    device_conf = _conf(tmp, "device.conf", **DEVICE_ENV_KEYS)
    small = ("--num_env_per_process", "4")
    device = _chain([_torchrun(tmp, device_conf, "device", *small, "--total_updates", "2"),
                     _torchrun(tmp, device_conf, "device_resumed", *small, "--total_updates",
                               "3", "--load_model_path", str(tmp / "ck_device" / "device"))],
                    tmp)
    return dict(tmp=tmp, dpa=dpa, shapes=shapes, inputs=inputs, key=key, ranks=ranks,
                host=host, device=device, outputs=None)


def _rank_outputs(launched):
    if launched["outputs"] is None:
        for proc in launched["ranks"]:
            _join(proc)
        outs = []
        for r in range(WORLD):
            with open(launched["tmp"] / f"inputs.pkl.rank{r}", "rb") as f:
                outs.append(pickle.load(f))
        launched["outputs"] = outs
    return launched["outputs"]


def _port_agent(inputs, process_group=None):
    cfg = port_config.Config(vit=port_config.ViTConfig(**TINY), **COMMON)
    agent = RNDAgent(cfg, N_ACT, device="cpu", process_group=process_group)
    state = agent.init_state(0)
    load_jax_params(agent, inputs["params"], inputs["rnd_target"])
    return agent, agent.update_obs_rms(state, inputs["frames"])


def _port_rollout(ro):
    return Rollout(**{k: torch.from_numpy(np.asarray(v)) for k, v in ro.items()})


# ---------------------------------------------------------------------------
# two gloo ranks against DataParallelAgent
# ---------------------------------------------------------------------------


def test_two_gloo_ranks_update_as_data_parallel_agent(launched):
    dpa, inputs = launched["dpa"], launched["inputs"]
    shapes = launched["shapes"]
    jst = JaxAgentState(  # what init_state builds around its parameters
        params=inputs["params"], rnd_target=inputs["rnd_target"], ssl_target=None,
        opt_state=dpa.agent.tx.init(inputs["params"]),
        obs_rms=jax_norm.rms_init(shapes.obs_rms.mean.shape),
        reward_rms=jax_norm.rms_init(()), reward_filter=jax_norm.reward_filter_init(N_ENV),
        global_step=jnp.zeros((2,), jnp.int32), global_update=jnp.zeros((), jnp.int32))
    shardings = jax.tree_util.tree_map(lambda s: NamedSharding(dpa.mesh, s),
                                       dpa._state_spec_fn(jst))
    jst = dpa.update_obs_rms(jax.device_put(jst, shardings), jnp.asarray(inputs["frames"]))
    jro = JaxRollout(**{k: jnp.asarray(v) for k, v in inputs["rollout"].items()})
    jnew, jmetrics = dpa.update(jst, jro, launched["key"])
    outs = _rank_outputs(launched)

    jm = {k: float(v) for k, v in jmetrics.items()}
    assert any(k.startswith("train/") for k in jm) and any(k.startswith("data/") for k in jm)
    for out in outs:
        assert set(out["metrics"]) == set(jm)
        for k in jm:
            np.testing.assert_allclose(out["metrics"][k], jm[k], err_msg=k, **METRIC_TOL)
    n_local = N_ENV // WORLD
    for r, out in enumerate(outs):
        st = out["state"]
        for ours, ref in ((st["obs_rms"], jnew.obs_rms), (st["reward_rms"], jnew.reward_rms)):
            for a, b in zip(ours, ref):
                np.testing.assert_allclose(a, _np(b), **TOL)
        np.testing.assert_allclose(st["rewems"],
                                   _np(jnew.reward_filter.rewems)[r * n_local:(r + 1) * n_local],
                                   **TOL)
        assert st["global_update"] == int(jnew.global_update) == 1
        # each rank counts its own frames, as each shard does
        assert st["global_step"] == global_step_value(jnew) == N_STEP * n_local
    for key in ("policy", "rnd_pred"):
        ref = flax_tree_to_torch(jax.tree_util.tree_map(_np, jnew.params[key]))
        assert set(outs[0]["params"][key]) == set(ref)
        for name, value in ref.items():
            np.testing.assert_allclose(outs[0]["params"][key][name], value,
                                       err_msg=f"{key}.{name}", rtol=0, atol=PARAM_ATOL)
            # the replicas are equal bit for bit
            np.testing.assert_array_equal(outs[0]["params"][key][name],
                                          outs[1]["params"][key][name])
    # the two halves of the fleet really had other data
    assert not np.array_equal(outs[0]["state"]["rewems"], outs[1]["state"]["rewems"])


def _assert_moments(ours, ref: norm.RMSState, x: np.ndarray) -> None:
    """``ours`` (mean, var, count) against ``ref`` at the criteria of the
    module doc; ``x`` the batch folded in (its second moment sets the
    variance's scale)."""
    mean, var, count = ours
    assert mean.shape == tuple(ref.mean.shape) and var.shape == tuple(ref.var.shape)
    np.testing.assert_allclose(mean, ref.mean.numpy(), rtol=MOMENT_RTOL,
                               atol=MOMENT_RTOL * float(np.abs(x).mean()))
    second = float(np.square(x.astype(np.float64)).mean())
    np.testing.assert_allclose(var, ref.var.numpy(), rtol=0, atol=MOMENT_RTOL * second)
    assert float(count) == float(ref.count)


@pytest.mark.parametrize("name", ["pixels", "embeddings"])
def test_rms_update_over_two_ranks_is_one_process_over_both(launched, name):
    x, shape = launched["inputs"]["moments"][name]
    ref = norm.rms_update(norm.rms_init(shape), torch.from_numpy(x))
    for out in _rank_outputs(launched):
        _assert_moments(out["moments"][name], ref, x)


def test_prepare_batch_over_two_ranks_pools_reward_and_obs_moments(launched):
    """The reward RMS from every rank's filtered returns and ``obs_rms`` from
    every rank's next-obs: one process's on the whole rollout."""
    inputs = launched["inputs"]
    agent, state = _port_agent(inputs)
    ref, _, _ = agent.prepare_batch(state, _port_rollout(inputs["rollout"]))
    outs = _rank_outputs(launched)
    # the scale of what each RMS folded in: the next-obs pixels; the
    # filtered returns, whose last step (rewems) is the largest of the series
    returns = ref.reward_filter.rewems.numpy()
    for out in outs:
        _assert_moments(out["prepared"]["obs_rms"], ref.obs_rms,
                        inputs["rollout"]["next_obs"].astype(np.float32))
        _assert_moments(out["prepared"]["reward_rms"], ref.reward_rms, returns)
    np.testing.assert_allclose(np.concatenate([o["prepared"]["rewems"] for o in outs]),
                               returns, rtol=MOMENT_RTOL, atol=0)


# ---------------------------------------------------------------------------
# the port alone
# ---------------------------------------------------------------------------


def test_a_group_of_one_changes_no_bit(launched, tmp_path):
    inputs = launched["inputs"]
    ro = _port_rollout(inputs["rollout"])
    plain, plain_state = _port_agent(inputs)
    dp.init_distributed(f"file://{tmp_path / 'store'}", 1, 0, backend="gloo", timeout=60)
    try:
        grouped, grouped_state = _port_agent(inputs, dp.default_group())
        assert dp.group_size(grouped.process_group) == 1
        with pytest.raises(ValueError, match="fits neither"):  # a checkpoint of 6 envs
            dp.rank_slice(torch.arange(6), 4, grouped.process_group)
        results = [agent.update(st, ro, Rng(3, "cpu"))
                   for agent, st in ((plain, plain_state), (grouped, grouped_state))]
    finally:
        dist.destroy_process_group()
    (a_state, a_metrics), (b_state, b_metrics) = results
    assert list(a_metrics) == list(b_metrics)
    for k in a_metrics:
        assert torch.equal(a_metrics[k], b_metrics[k]), k
    for a, b in zip(dp.flatten_tensors([tuple(a_state.obs_rms), tuple(a_state.reward_rms),
                                        a_state.reward_filter.rewems]),
                    dp.flatten_tensors([tuple(b_state.obs_rms), tuple(b_state.reward_rms),
                                        b_state.reward_filter.rewems])):
        assert torch.equal(a, b)
    for pa, pb in zip(plain.trainable_parameters(), grouped.trainable_parameters()):
        assert torch.equal(pa, pb)


def _log(tmp, tag, rank):
    return (tmp / "logs" / f"{tag}_rank{rank}.log").read_text()


def _digest(log: str) -> str:
    return log.split("parameter digest ")[1].split()[0]


def test_torchrun_two_ranks_train_on_the_host_env(launched):
    tmp = launched["tmp"]
    _join(launched["host"])
    logs = [_log(tmp, "host", r) for r in range(WORLD)]
    assert all("update 2 | global_step 128" in log for log in logs)
    assert _digest(logs[0]) == _digest(logs[1])  # the replicas are equal bit for bit
    seeds = [log.split("seeds ")[1].split()[0] for log in logs]
    assert seeds == ["42..45", "46..49"]  # disjoint fleets, seeded by rank
    # one checkpoint, written by rank 0, with both ranks' rewems in rank order
    ck = tmp / "ck_host"
    payload = torch.load(ck / "host.pt", weights_only=True)
    rewems = payload["agent_state"]["reward_filter"][0]
    assert rewems.shape == (WORLD * 4,) and not torch.equal(rewems[:4], rewems[4:])
    meta = json.loads((ck / "host.json").read_text())
    assert meta["global_update"] == 2 and len(meta["episode_stats_by_rank"]) == WORLD
    # scalars from rank 0 only
    lines = (tmp / "logs" / "host_scalars.jsonl").read_text().strip().splitlines()
    assert [json.loads(ln)["step"] for ln in lines] == [1, 2]
    logs = [_log(tmp, "host_resumed", r) for r in range(WORLD)]
    assert all("resumed from" in log and "update 3 | global_step 192" in log
               and "update 2 |" not in log for log in logs)
    assert _digest(logs[0]) == _digest(logs[1])


def test_torchrun_two_ranks_train_on_the_device_env(launched):
    tmp = launched["tmp"]
    _join(launched["device"])
    logs = [_log(tmp, "device", r) for r in range(WORLD)]
    assert "envs 0..1 of 4" in logs[0] and "envs 2..3 of 4" in logs[1]
    assert all("update 2 | global_step 32" in log for log in logs)
    assert _digest(logs[0]) == _digest(logs[1])
    last = json.loads((tmp / "logs" / "device_scalars.jsonl").read_text().splitlines()[-1])
    meta = json.loads((tmp / "ck_device" / "device.json").read_text())
    stats = meta["device_env_stats"]
    assert meta["global_update"] == 2 and stats["ever_visited_shape"] == [4, 16]
    finished = stats["finished_episodes"]
    # every rank's episodes counted: the whole fleet's, not rank 0's half
    assert last["data/num_episodes"] == sum(finished) > sum(finished[:2]) > 0
    payload = torch.load(tmp / "ck_device" / "device.pt", weights_only=True)
    assert payload["agent_state"]["reward_filter"][0].shape == (4,)
    logs = [_log(tmp, "device_resumed", r) for r in range(WORLD)]
    assert all("resumed from" in log and "update 3 | global_step 48" in log for log in logs)
    assert _digest(logs[0]) == _digest(logs[1])
    # the restored rooms: the fleet's frontier can only grow after the restart
    rooms = json.loads((tmp / "logs" / "device_resumed_scalars.jsonl").read_text())
    assert rooms["data/total_rooms_discovered"] >= last["data/total_rooms_discovered"]


def test_data_axis_size_other_than_the_ranks_raises(tmp_path):
    cfg = port_config.Config(vit=port_config.ViTConfig(**TINY), data_axis_size=2,
                             env_type=port_config.EnvType.SYNTHETIC,
                             save_model_path=str(tmp_path))
    with pytest.raises(ValueError, match=r"DataAxisSize = 2 but 1 rank.*--nproc_per_node 2"):
        train(cfg, total_updates=1, log_dir=str(tmp_path), device="cpu")
    assert dp.data_axis_size(cfg.replace(data_axis_size=0), 3) == 3
    with pytest.raises(ValueError, match="DataAxisSize = 1 but 2"):
        dp.data_axis_size(cfg.replace(data_axis_size=1), 2)


def test_env_axis_helpers_without_a_group():
    assert dp.get_dist_info() == (1, 0, 1, 0)
    assert dp.env_slice(6, None) == (0, 6) and dp.rank_seed(7, 0) == 7
    assert len({dp.rank_seed(7, r) for r in range(4)}) == 4
    t = torch.arange(6)
    # without a group a checkpoint's per-env array is taken as it is (an
    # evaluation agent of one env loads a training fleet's)
    assert dp.rank_slice(t, 6, None) is t and dp.rank_slice(t, 1, None) is t
    assert dp.gather_envs(t, None) is t and dp.broadcast_object(5, None) == 5
    x = torch.ones(3)
    dp.all_reduce_mean_([x], None)
    dp.psum_([x], None)
    assert torch.equal(x, torch.ones(3))
