"""The torch port's zero-host path (``EnvType = synthetic_device``) against
the JAX package, on the CPU at tiny sizes.

- Worlds: ``make_device_env`` builds the JAX package's room frames, walls,
  goal rooms and initial state bit for bit (sine and noise textures, maze on
  and off, a shared world, 3 variants, sparse goals at depth 0 and 3).
- Steps: a fixed action sequence gives equal stacks, rewards, dones,
  truncations and state fields to ``eavit_tpu``'s ``device_env_step``,
  through truncation and auto-reset, blocked maze moves and the sparse goal.
- Collector: at dropout 0 and float32, with one flax tree loaded into both
  agents, the port's ``ScanRolloutCollector`` rollout replays through the JAX
  env and network: states, rewards, dones and next_obs equal, logits and both
  values within 1e-5.
- Train: ``train.train`` on ``EnvType = synthetic_device`` for two updates,
  finite metrics under the JAX names, and a resume that brings back the
  env's ever-visited rooms; the checkpoint's ``device_env_stats`` decode with
  either package's ``_restore_device_env_stats``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eavit_tpu import config as jax_config
from eavit_tpu import train as jax_train
from eavit_tpu.envs import device_env as jax_env
from eavit_tpu.rl.agent import RNDAgent as JaxAgent
from eavit_tpu_torch import config as port_config
from eavit_tpu_torch import train as port_train
from eavit_tpu_torch.convert import load_jax_params
from eavit_tpu_torch.envs import device_env as port_env
from eavit_tpu_torch.models.layers import Rng
from eavit_tpu_torch.rl.agent import RNDAgent
from eavit_tpu_torch.rl.scan_rollout import ScanRolloutCollector

from _torch_port_jax_state import agent_state

# One intra-op thread: the suite runs several test processes on one host.
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
STATE_FIELDS = port_env.DeviceEnvState._fields
# (kwargs of make_device_env) the world cases; frames 16 x 16
WORLDS = {
    "sine": dict(texture="sine"),
    "noise_maze": dict(texture="noise", maze=True),
    "sine_maze_shared_variants3": dict(texture="sine", maze=True, shared_world=True,
                                       variants=3),
    "noise_sparse_depth0": dict(texture="noise", maze=True, sparse_goal=True),
    "sine_maze_sparse_depth3": dict(texture="sine", maze=True, sparse_goal=True,
                                    goal_depth=3),
    "torus_sparse_shared": dict(texture="sine", shared_world=True, sparse_goal=True),
}


def _np(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


def _both(num_envs, **kw):
    kw = dict(dict(seed=5, grid=5, height=16, width=16, max_episode_steps=7), **kw)
    return jax_env.make_device_env(num_envs, **kw), port_env.make_device_env(num_envs, **kw)


def _assert_states_equal(ours, ref, what):
    for name in STATE_FIELDS:
        a, b = _np(getattr(ours, name)), _np(getattr(ref, name))
        assert a.dtype == b.dtype, f"{what}: {name} dtype {a.dtype} != {b.dtype}"
        np.testing.assert_array_equal(a, b, err_msg=f"{what}: {name}")


@pytest.mark.parametrize("case", sorted(WORLDS))
def test_worlds_equal_jax(case):
    (jp, js), (pp, ps) = _both(3, **WORLDS[case])
    np.testing.assert_array_equal(_np(pp.frames), _np(jp.frames))
    np.testing.assert_array_equal(_np(pp.walls), _np(jp.walls))
    assert (pp.grid, pp.stack, pp.max_episode_steps) == (jp.grid, jp.stack,
                                                          jp.max_episode_steps)
    if jp.goal_rooms is None:
        assert pp.goal_rooms is None
    else:
        np.testing.assert_array_equal(_np(pp.goal_rooms), _np(jp.goal_rooms))
        assert pp.goal_rooms.dtype == torch.int32
    _assert_states_equal(ps, js, "reset")


@pytest.mark.parametrize("case", ["noise_maze", "sine_maze_shared_variants3",
                                  "sine_maze_sparse_depth3"])
def test_steps_equal_jax(case):
    """40 steps of actions from ``default_rng(0)``: every output and state
    field equal, across truncation (cap 7), auto-reset, moves into walls and,
    in the sparse case, the goal room."""
    kw = dict(WORLDS[case])
    if kw.get("sparse_goal"):
        kw["goal_depth"] = 1  # next to the spawn, so that random walks reach it
    (jp, js), (pp, ps) = _both(3, **kw)
    step = jax.jit(lambda s, a: jax_env.device_env_step(jp, s, a))
    actions = np.random.default_rng(0).integers(0, 5, (40, 3))
    blocked = truncations = goals = 0
    for t, a in enumerate(actions):
        js, jr, jd, jt = step(js, jnp.asarray(a, jnp.int32))
        prev = ps.pos.clone()
        ps, pr, pd, pt = port_env.device_env_step(pp, ps, torch.from_numpy(a))
        for ours, ref, name in ((pr, jr, "reward"), (pd, jd, "dones"), (pt, jt, "truncated")):
            assert _np(ours).dtype == _np(ref).dtype, name
            np.testing.assert_array_equal(_np(ours), _np(ref), err_msg=f"step {t}: {name}")
        _assert_states_equal(ps, js, f"step {t}")
        stayed = (ps.pos == prev).all(dim=1) & (torch.from_numpy(a) > 0) & ~(pd | pt)
        blocked += int(stayed.sum())
        truncations += int(pt.sum())
        goals += int(pd.sum())
    assert blocked > 0 and truncations > 0
    assert goals > 0 or not kw.get("sparse_goal")


# ---------------------------------------------------------------------------
# the collector and train at synthetic_demo.conf's ViT, 84 x 84 frames
# ---------------------------------------------------------------------------

DEMO_VIT = dict(dim=64, patch_size=12, depth=2, heads=4, dim_head=16, mlp_dim=128)
N_ENV, N_STEP, N_ACT = 2, 8, 5
COMMON = dict(num_env_per_process=N_ENV, num_step=N_STEP, compute_dtype="float32",
              shared_patch_stream=True, epoch=1, mini_batch=2, obs_norm_step=1,
              env_type="synthetic_device", synthetic_grid=4, max_step_per_episode=6,
              synthetic_maze=True, seed=3)


def test_collector_replays_through_jax():
    jcfg = jax_config.Config(vit=jax_config.ViTConfig(**DEMO_VIT, dropout=0.0,
                                                      emb_dropout=0.0),
                             attention_impl="xla", fused_ffn=False,
                             **dict(COMMON, env_type=jax_config.EnvType.SYNTHETIC_DEVICE))
    pcfg = port_config.Config(vit=port_config.ViTConfig(**DEMO_VIT, dropout=0.0,
                                                        emb_dropout=0.0),
                              attention_impl="pallas_qkv", fused_ffn=True,
                              **dict(COMMON, env_type=port_config.EnvType.SYNTHETIC_DEVICE))
    jag = JaxAgent(jcfg, N_ACT)
    jst = agent_state(jag, 0)  # drawn with numpy: no init_state to compile
    pag = RNDAgent(pcfg, N_ACT, device="cpu")
    pag.init_state(0)
    load_jax_params(pag, jax.tree_util.tree_map(_np, jst.params),
                    jax.tree_util.tree_map(_np, jst.rnd_target))
    kw = dict(seed=3, grid=4, max_episode_steps=6, maze=True)
    jp, js = jax_env.make_device_env(N_ENV, **kw)
    pp, ps = port_env.make_device_env(N_ENV, **kw)

    ro, ps_end, metrics = ScanRolloutCollector(pcfg, pag, pp).collect(ps, Rng(7, "cpu"))
    assert ro.states.shape == (N_STEP, N_ENV, 4, 84, 84) and ro.next_obs.shape[2] == 1
    assert ro.value_ext.shape == (N_STEP + 1, N_ENV)

    apply = jax.jit(lambda s: jag.network.apply({"params": jst.params["policy"]},
                                                s.astype(jnp.float32) / 255.0, True))
    step = jax.jit(lambda s, a: jax_env.device_env_step(jp, s, a))
    for t in range(N_STEP + 1):
        out = apply(js.stack)
        np.testing.assert_allclose(_np(ro.value_ext[t]), _np(out.value_ext[:, 0]), **TOL)
        np.testing.assert_allclose(_np(ro.value_int[t]), _np(out.value_int[:, 0]), **TOL)
        if t == N_STEP:
            break
        np.testing.assert_array_equal(_np(ro.states[t]), _np(js.stack))
        np.testing.assert_allclose(_np(ro.policy[t]), _np(out.policy), **TOL)
        js, jr, jd, _ = step(js, jnp.asarray(_np(ro.actions[t]), jnp.int32))
        np.testing.assert_array_equal(_np(ro.rewards[t]), _np(jr))
        np.testing.assert_array_equal(_np(ro.dones[t]), _np(jd))
        np.testing.assert_array_equal(_np(ro.next_obs[t]), _np(js.stack[:, -1:]))
    _assert_states_equal(ps_end, js, "after the rollout")
    assert set(metrics) == {"data/num_episodes", "data/mean_undiscounted_episode_return",
                            "data/mean_number_of_visited_rooms", "data/mean_rooms_discovered",
                            "data/total_rooms_discovered"}
    assert float(metrics["data/num_episodes"]) == float(_np(js.finished_episodes).sum())


def _train_cfg(tmp_path, **kw):
    return port_config.Config(
        vit=port_config.ViTConfig(**DEMO_VIT), attention_impl="pallas_qkv", fused_ffn=True,
        save_model_path=str(tmp_path / "ckpt"), log_name="dev", save_ckpt_every=2,
        **dict(COMMON, env_type=port_config.EnvType.SYNTHETIC_DEVICE, **kw))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("device_train")
    cfg = _train_cfg(tmp)
    metrics = port_train.train(cfg, total_updates=2, log_dir=str(tmp / "logs"), device="cpu")
    return cfg, tmp, metrics


def test_train_two_updates_on_the_device_env(trained):
    cfg, tmp, metrics = trained
    for key in ("train/loss", "train/actor_loss", "train/critic_loss", "train/entropy",
                "train/rnd_loss", "train/grad_norm_unclipped", "train/approx_kl",
                "data/int_reward_per_rollout", "data/num_episodes",
                "data/mean_undiscounted_episode_return", "data/mean_number_of_visited_rooms",
                "data/mean_rooms_discovered", "data/total_rooms_discovered"):
        assert key in metrics, key
    assert all(np.isfinite(v) for v in metrics.values())
    assert metrics["data/num_episodes"] > 0  # 6-step episodes in 16 steps
    meta = json.loads((tmp / "ckpt" / "dev.json").read_text())
    assert meta["global_update"] == 2 and meta["global_step"] == 2 * N_ENV * N_STEP
    assert meta["device_env_stats"]["ever_visited_shape"] == [N_ENV, 16]


def test_resume_restores_the_env_bookkeeping(trained, tmp_path):
    cfg, tmp, metrics = trained
    path = str(tmp / "ckpt" / "dev")
    meta = json.loads((tmp / "ckpt" / "dev.json").read_text())
    # the sidecar decodes with either package's reader, and each package's
    # writer is read by the other
    pp, fresh = port_env.make_device_env(N_ENV, seed=3, grid=4, max_episode_steps=6,
                                         maze=True)
    ours = port_train._restore_device_env_stats(fresh, meta)
    _, jfresh = jax_env.make_device_env(N_ENV, seed=3, grid=4, max_episode_steps=6,
                                        maze=True)
    ref = jax_train._restore_device_env_stats(jfresh, meta)
    _assert_states_equal(ours, ref, "restored")
    assert int(ours.ever_visited.sum()) > N_ENV  # rooms beyond the start room
    assert json.loads(json.dumps(jax_train._device_env_stats_meta(ref))) == \
        json.loads(json.dumps(port_train._device_env_stats_meta(ours)))
    assert port_train._restore_device_env_stats(fresh, {}) is fresh

    resumed = port_train.train(cfg.replace(load_model=True, load_model_path=path,
                                           log_name="dev_resumed",
                                           save_model_path=str(tmp_path / "ck")),
                               total_updates=3, log_dir=str(tmp_path / "logs"),
                               device="cpu")
    assert np.isfinite(resumed["train/loss"])
    # one rollout after the restart can only grow the restored frontier
    assert resumed["data/mean_rooms_discovered"] >= float(ours.ever_visited.sum()) / N_ENV
    lines = (tmp_path / "logs" / "dev_resumed_scalars.jsonl").read_text().splitlines()
    assert [json.loads(ln)["step"] for ln in lines] == [3]
