"""The port's env stack (``eavit_tpu_torch/envs/wrappers.py``, ``pool.py``,
``builders.py``), its renderer and the classic-control configs against the
JAX package.

- Every wrapper on a scripted gym env, with the same actions as the JAX
  wrapper: observations, rewards, flags and infos equal (the Atari and Mario
  wrappers included, whose emulators are not installed).
- The classic-control fleet of ``make_vector_env`` on ``CartPole-v1`` and on
  ``Pendulum-v1`` (``RewardScale``, ``ActionScaleWrapper``) with the same
  seeds and actions as ``eavit_tpu.envs.builders.make_vector_env``: frames,
  rewards, dones, truncations and infos bit for bit over 40 steps that cross
  an auto-reset (the wall-clock ``t`` of an episode's info aside).
- ``ThreadVectorEnv`` equals ``SyncVectorEnv`` on an env whose reset is
  deterministic, and the JAX package's ``SyncVectorEnv`` on Pendulum;
  ``sample_random_actions`` draws the JAX package's values under one numpy
  seed.
- The renderer under matplotlib's Agg backend, as ``test_renderer_headless``
  runs the JAX one, and ``make_animation``.
- ``train.train`` on ``configs/pendulum_continuous.conf`` and
  ``configs/classic_control_flagship.conf``, cut to patch 21, dim 32, depth 1
  (2 heads x 16, MLP 64), 2 envs x 8 steps, one update of one epoch of two
  minibatches: finite losses, and ``evaluate(greedy=True)`` plays one
  Pendulum episode of 10 steps from the checkpoint.
- The env modules, the renderer and the entry points import without
  gymnasium, cv2, pygame and matplotlib (the GPU machine has none of them),
  and building a classic-control env there raises ``ImportError`` naming
  gymnasium.

The tests that need gymnasium skip without it, as the JAX package's do.
"""

import dataclasses
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from eavit_tpu import config as jax_config
from eavit_tpu.envs import builders as jax_builders
from eavit_tpu.envs import wrappers as JW
from eavit_tpu_torch import config as port_config
from eavit_tpu_torch.envs import builders
from eavit_tpu_torch.envs import wrappers as W

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _gym():
    return pytest.importorskip("gymnasium")


def _same_info(a, b):
    """Infos equal, but for the wall-clock seconds of a finished episode."""
    def strip(info):
        info = dict(info)
        if "episode" in info:
            info["episode"] = {k: v for k, v in info["episode"].items() if k != "t"}
        return info

    assert strip(a) == strip(b)


def _same_step(ours, ref):
    for x, y in zip(ours[:4], ref[:4]):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    infos_a, infos_b = ours[4], ref[4]
    if isinstance(infos_a, dict):
        infos_a, infos_b = [infos_a], [infos_b]
    for a, b in zip(infos_a, infos_b):
        _same_info(a, b)


# ---------------------------------------------------------------------------
# wrappers on a scripted env
# ---------------------------------------------------------------------------


def _scripted_env(gym, kind: str):
    class Scripted(gym.Env):
        """Frame t is an RGB image of level t % 251 with a gradient; reward
        t; terminates at t = 7 (a life is lost at t = 3)."""

        def __init__(self):
            self.observation_space = gym.spaces.Box(0, 255, (10, 12, 3), np.uint8)
            if kind == "box":
                self.action_space = gym.spaces.Box(-2.0, 2.0, (1,), np.float32)
            else:
                self.action_space = gym.spaces.Discrete(4)
            self.t = 0

        def _frame(self):
            ramp = np.arange(12, dtype=np.int64)[None, :, None] * np.array([3, 5, 7])
            return ((self.t * 17 + ramp) % 251 + np.zeros((10, 1, 1), np.int64)).astype(
                np.uint8)

        def reset(self, **kw):
            self.t = 0
            return self._frame(), {}

        def step(self, action):
            self.t += 1
            r = float(np.sum(action)) + self.t
            return self._frame(), r, self.t >= 7, False, {"life": 3 - (self.t >= 3)}

        def render(self):
            return self._frame()

    return Scripted()


WRAPPERS = {  # name -> (builder of the wrapper stack from a wrappers module, env kind)
    "sticky": (lambda M, e: M.StickyActionWrapper(e, 0.5, seed=3), "discrete"),
    "max_and_skip": (lambda M, e: M.MaxAndSkipWrapper(e, skip=4), "discrete"),
    "gray_resize_stack": (lambda M, e: M.FrameStackWrapper(
        M.ResizeAndGrayScaleWrapper(e, 6, 5), 3), "discrete"),
    "step_cap_monitor": (lambda M, e: M.MonitorWrapper(M.MaxStepPerEpisodeWrapper(e, 5)),
                         "discrete"),
    "rgb_observation": (lambda M, e: M.RGBArrayAsObservationWrapper(e), "discrete"),
    "mario_reward": (lambda M, e: M.MarioRewardWrapper(e, life_done=True), "discrete"),
    "reward_scale": (lambda M, e: M.RewardScaleWrapper(e, 0.0625), "discrete"),
    "action_offset": (lambda M, e: M.ActionOffsetWrapper(e, 1), "discrete"),
    "action_scale": (lambda M, e: M.ActionScaleWrapper(e), "box"),
}


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_wrapper_matches_jax(name):
    gym = _gym()
    build, kind = WRAPPERS[name]
    ours, ref = build(W, _scripted_env(gym, kind)), build(JW, _scripted_env(gym, kind))
    assert ours.observation_space == ref.observation_space
    assert ours.action_space == ref.action_space
    for a, b in zip(ours.reset(), ref.reset()):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    rng = np.random.default_rng(0)
    for _ in range(9):
        if kind == "box":
            act = rng.uniform(-1.5, 1.5, 1).astype(np.float32)  # clipped past 1
        else:
            act = int(rng.integers(0, ours.action_space.n))
        out, want = ours.step(act), ref.step(act)
        _same_step(out, want)
        if out[2] or out[3]:
            ours.reset(), ref.reset()


# ---------------------------------------------------------------------------
# the classic-control fleet
# ---------------------------------------------------------------------------


def _cc_cfgs(env_id: str, **kw):
    kw = dict(env_type="classic_control", env_id=env_id, sticky_action=False,
              max_step_per_episode=15, num_env_per_process=2, seed=11,
              reward_scale=0.0625 if env_id == "Pendulum-v1" else 1.0, **kw)
    return (jax_config.Config(**{**kw, "env_type": jax_config.EnvType.CLASSIC_CONTROL}),
            port_config.Config(**{**kw, "env_type": port_config.EnvType.CLASSIC_CONTROL}))


def _actions(env_id: str, rng, n: int):
    if env_id == "Pendulum-v1":
        return rng.uniform(-1.3, 1.3, (n, 1)).astype(np.float32)  # clipped past 1
    return rng.integers(0, 2, n)


@pytest.mark.parametrize("env_id", ["CartPole-v1", "Pendulum-v1"])
def test_classic_control_fleet_matches_jax(env_id):
    _gym()
    jcfg, pcfg = _cc_cfgs(env_id)
    ours, ref = builders.make_vector_env(pcfg), jax_builders.make_vector_env(jcfg)
    try:
        assert (ours.action_space_n, ours.action_dim) == (ref.action_space_n, ref.action_dim)
        s0 = ours.reset()
        assert s0.shape == (2, 4, 84, 84) and s0.dtype == np.uint8
        np.testing.assert_array_equal(s0, ref.reset())
        rng = np.random.default_rng(1)
        ends = 0
        for _ in range(40):
            act = _actions(env_id, rng, 2)
            out, want = ours.step(act), ref.step(act)
            _same_step(out, want)
            ends += int(np.sum(out[2] | out[3]))
        assert ends >= 2  # episodes ended and the fleet reset itself
        if env_id == "Pendulum-v1":  # the scaled reward lies in the update's clip
            assert ours.action_dim == 1 and np.all(out[1] >= -1.02)
    finally:
        ours.close()
        ref.close()


@pytest.mark.parametrize("env_id", ["CartPole-v1", "Pendulum-v1"])
def test_sample_random_actions_match_jax(env_id):
    _gym()
    jcfg, pcfg = _cc_cfgs(env_id)
    ours, ref = builders.make_vector_env(pcfg), jax_builders.make_vector_env(jcfg)
    a = ours.sample_random_actions(np.random.default_rng(5))
    b = ref.sample_random_actions(np.random.default_rng(5))
    assert a.dtype == b.dtype and a.shape == (2,) + (() if env_id == "CartPole-v1" else (1,))
    np.testing.assert_array_equal(a, b)
    ours.close()
    ref.close()


def test_thread_pool_matches_sync_pool():
    """On envs whose reset is deterministic the two pools give the same
    stream; on Pendulum the thread pool equals the JAX package's
    ``SyncVectorEnv`` reset once more first, as the thread workers reset
    each env once before the first ``reset`` (``eavit_tpu/envs/pool.py:117``).
    The reference is a synchronous pool: pygame renders from several threads
    at once are not deterministic, which is why the port's renders hold one
    lock (``envs/wrappers.py``)."""
    gym = _gym()
    from eavit_tpu.envs.pool import SyncVectorEnv as JaxSync
    from eavit_tpu_torch.envs.pool import SyncVectorEnv, ThreadVectorEnv

    build, _ = WRAPPERS["step_cap_monitor"]
    fns = [lambda: build(W, _scripted_env(gym, "discrete")) for _ in range(2)]
    sync, threads = SyncVectorEnv(fns), ThreadVectorEnv(fns)
    jcfg, pcfg = _cc_cfgs("Pendulum-v1", async_env_pool=True)
    ours = builders.make_vector_env(pcfg)
    ref = JaxSync([jax_builders.make_classic_control_env(jcfg, s)
                   for s in (jcfg.seed, jcfg.seed + 1)])
    assert type(ours) is ThreadVectorEnv
    try:
        np.testing.assert_array_equal(sync.reset(), threads.reset())
        ref.reset()  # the thread workers' own first reset
        np.testing.assert_array_equal(ours.reset(), ref.reset())
        rng = np.random.default_rng(2)
        for _ in range(12):
            act = rng.integers(0, 4, 2)
            _same_step(threads.step(act), sync.step(act))
            act = _actions("Pendulum-v1", rng, 2)
            _same_step(ours.step(act), ref.step(act))
    finally:
        for pool in (sync, threads, ours, ref):
            pool.close()


# ---------------------------------------------------------------------------
# renderer
# ---------------------------------------------------------------------------


def test_renderer_headless(tmp_path):
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg")
    from eavit_tpu_torch.utils.renderer import ParallelizedEnvironmentRenderer, make_animation

    r = ParallelizedEnvironmentRenderer(3)
    obs = np.random.default_rng(0).integers(0, 256, (3, 1, 84, 84), np.uint8)
    r.render(obs)
    r.render(obs // 2)
    assert len(r.images) == 3
    np.testing.assert_array_equal(np.asarray(r.images[1].get_array()), obs[1, 0] // 2)
    r.close()
    path = tmp_path / "trace.pkl"
    with open(path, "wb") as f:
        pickle.dump(list(np.random.default_rng(1).random(20)), f)
    assert make_animation(str(path)) is not None


# ---------------------------------------------------------------------------
# train and evaluate on the classic-control configs
# ---------------------------------------------------------------------------

CUT_VIT = dict(patch_size=21, dim=32, depth=1, heads=2, dim_head=16, mlp_dim=64)


@pytest.mark.parametrize("conf", ["pendulum_continuous.conf", "classic_control_flagship.conf"])
def test_train_runs_on_the_classic_control_config(conf, tmp_path):
    _gym()
    from eavit_tpu_torch.eval import evaluate
    from eavit_tpu_torch.train import train

    cfg = port_config.load_config(os.path.join(REPO, "configs", conf))
    assert cfg.env_type == port_config.EnvType.CLASSIC_CONTROL
    cfg = cfg.replace(vit=dataclasses.replace(cfg.vit, **CUT_VIT), num_env_per_process=2,
                      num_step=8, epoch=1, mini_batch=2, save_ckpt_every=1, log_name="cc",
                      save_model_path=str(tmp_path / "ckpt"))
    metrics = train(cfg, total_updates=1, log_dir=str(tmp_path / "logs"), device="cpu")
    losses = [v for k, v in metrics.items() if k.startswith("train/")]
    assert losses and all(np.isfinite(v) for v in losses)
    if conf.startswith("pendulum"):
        out = evaluate(cfg.replace(load_model_path=str(tmp_path / "ckpt" / "cc"),
                                   max_step_per_episode=10),
                       num_episodes=1, greedy=True, log_dir=str(tmp_path / "logs"),
                       device="cpu")
        assert out["episodes"] == 1 and np.isfinite(out["mean_return"])


def test_env_modules_import_without_gymnasium():
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('gymnasium', 'cv2', 'pygame', 'matplotlib'):\n"
        "            raise ImportError(f'blocked: {name}')\n"
        "sys.meta_path.insert(0, Block())\n"
        "from eavit_tpu_torch.envs import builders, pool, wrappers\n"
        "from eavit_tpu_torch.utils import renderer\n"
        "from eavit_tpu_torch import eval, train\n"
        "from eavit_tpu_torch.config import Config, EnvType\n"
        "try:\n"
        "    builders.make_vector_env(Config(env_type=EnvType.CLASSIC_CONTROL,\n"
        "                                    num_env_per_process=1))\n"
        "except ImportError as e:\n"
        "    assert 'gymnasium' in str(e), e\n"
        "    print('raised')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and "raised" in res.stdout, res.stderr
