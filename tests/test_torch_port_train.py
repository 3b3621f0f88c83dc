"""The torch port's entry points (train, eval, CLI, checkpoints, ``load_jax_state``)
on the CPU at ``--debug_params`` sizes, and the rule that the port imports
nothing of JAX.

``train(cfg, total_updates=2)`` runs on the synthetic env with a two-layer
dim-48 ViT through the kernel routes (plain versions on the CPU). Checked:
finite metrics under the JAX package's names, a checkpoint round trip that is
bit-equal in parameters, optimizer state and normalisers, a resume that
continues the update count and skips the warm-up, ``evaluate`` from the
checkpoint, the CLI in a subprocess (including its refusal to run without a
GPU unless ``--device cpu`` is given), and ``load_jax_state``: one more
update from a JAX state carried over (Adam moments included) must match the
JAX package's own next update (parameters atol 2e-5, as in
test_torch_port_update.py).
"""

import ast
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eavit_tpu import config as jax_config
from eavit_tpu.rl.agent import RNDAgent as JaxAgent
from eavit_tpu.rl.agent import Rollout as JaxRollout
from eavit_tpu_torch import config as port_config
from eavit_tpu_torch.config import Config, EnvType, RepresentationMethod, ViTConfig
from eavit_tpu_torch.convert import flax_tree_to_torch, load_jax_state
from eavit_tpu_torch.envs.builders import make_vector_env
from eavit_tpu_torch.eval import evaluate
from eavit_tpu_torch.models.layers import Rng
from eavit_tpu_torch.rl.agent import RNDAgent, Rollout
from eavit_tpu_torch.parallel.dp import build_agent
from eavit_tpu_torch.train import train
from eavit_tpu_torch.utils.checkpoint import (
    BEST_SUFFIXES,
    CheckpointManager,
    load_checkpoint,
    save_checkpoint,
)
from eavit_tpu_torch.utils.logger import Logger

from _torch_port_jax_state import agent_state

# One intra-op thread: the suite runs several test processes on one host, and
# torch's thread pools spinning against each other (and against XLA's) make
# these many small ops an order of magnitude slower than one thread does.
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
TINY =dict(dim=48, patch_size=12, depth=2, heads=4, dim_head=12, mlp_dim=96)


def _cfg(tmp_path, **kw):
    base = dict(
        vit=ViTConfig(**TINY), env_type=EnvType.SYNTHETIC, epoch=2, mini_batch=4,
        max_step_per_episode=12, sticky_action=False, save_ckpt_every=2,
        attention_impl="pallas_qkv", fused_ffn=True, shared_patch_stream=True,
        save_model_path=str(tmp_path / "ckpt"), log_name="t", seed=3)
    base.update(kw)
    return Config(**base).with_debug_params()


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Two updates on the CPU; (cfg, log_dir, metrics)."""
    tmp = tmp_path_factory.mktemp("train")
    cfg = _cfg(tmp)
    metrics = train(cfg, total_updates=2, log_dir=str(tmp / "logs"), device="cpu")
    return cfg, tmp, metrics


def test_train_two_updates_on_cpu(trained):
    cfg, tmp, metrics = trained
    for key in ("train/loss", "train/actor_loss", "train/critic_loss", "train/entropy",
                "train/rnd_loss", "train/grad_norm_unclipped", "train/approx_kl",
                "data/int_reward_per_rollout", "data/ext_reward_per_rollout_mean",
                "data/num_episodes"):
        assert key in metrics, key
    assert all(np.isfinite(v) for v in metrics.values())
    assert metrics["data/num_episodes"] > 0  # 12-step episodes ended in 32 steps
    # scheduled save at update 2 and a best-rollout-reward save, with sidecars
    ck = pathlib.Path(cfg.save_model_path)
    assert (ck / "t.pt").exists() and (ck / "t.json").exists()
    assert (ck / ("t" + BEST_SUFFIXES["rollout_reward"] + ".pt")).exists()
    meta = json.loads((ck / "t.json").read_text())
    assert meta["global_update"] == 2 and meta["global_step"] == 2 * 16 * 4
    assert "episode_stats" in meta and "best_metrics" in meta
    # scalars reached the jsonl file, one line per update
    lines = (tmp / "logs" / "t_scalars.jsonl").read_text().strip().splitlines()
    assert [json.loads(ln)["step"] for ln in lines] == [1, 2]


def test_checkpoint_round_trip_is_bit_equal(trained, tmp_path):
    cfg, _, _ = trained
    path = os.path.join(cfg.save_model_path, "t")
    a = RNDAgent(cfg, 5, device="cpu")
    sa, meta = load_checkpoint(path, a)
    assert sa.global_update == 2 and sa.global_step == 128
    # save again from the loaded agent, load into a third: everything is equal
    save_checkpoint(str(tmp_path / "again"), a, sa, meta)
    b = RNDAgent(cfg, 5, device="cpu")
    b.init_state(99)  # other weights before the load
    sb, meta_b = load_checkpoint(str(tmp_path / "again.pt"), b)
    assert meta_b["global_update"] == 2
    for ma, mb in zip(a._modules().values(), b._modules().values()):
        for (na, pa), (nb, pb) in zip(ma.state_dict().items(), mb.state_dict().items()):
            assert na == nb and torch.equal(pa, pb)
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert oa["param_groups"] == ob["param_groups"]
    assert len(oa["state"]) == len(a.trainable_parameters()) > 0
    for k, st in oa["state"].items():
        assert float(st["step"]) == 2 * cfg.epoch * cfg.mini_batch
        for name in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(st[name], ob["state"][k][name])
    for ta, tb in zip((*sa.obs_rms, *sa.reward_rms, *sa.reward_filter),
                      (*sb.obs_rms, *sb.reward_rms, *sb.reward_filter)):
        assert torch.equal(ta, tb)
    assert (sa.global_update, sa.global_step) == (sb.global_update, sb.global_step)


def test_resume_continues_the_update_count(trained, tmp_path):
    cfg, _, _ = trained
    resumed = cfg.replace(load_model=True,
                          load_model_path=os.path.join(cfg.save_model_path, "t"),
                          save_model_path=str(tmp_path / "ckpt2"), log_name="r")
    metrics = train(resumed, total_updates=3, log_dir=str(tmp_path / "logs"),
                    device="cpu")
    assert np.isfinite(metrics["train/loss"])
    log = (tmp_path / "logs" / "r_rank0.log").read_text()
    assert "resumed from" in log and "@ update 2" in log
    assert "update 3 | global_step 192" in log and "update 2 |" not in log
    assert "obs-norm warm-up" not in log  # resume skips the warm-up
    # episode bookkeeping came back from the sidecar
    assert metrics["data/num_episodes"] > trained[2]["data/num_episodes"]


def test_evaluate_from_the_checkpoint(trained, tmp_path):
    cfg, _, _ = trained
    trace = tmp_path / "trace.pkl"
    out = evaluate(cfg.replace(load_model_path=os.path.join(cfg.save_model_path, "t")),
                   num_episodes=2, greedy=True, save_intrinsic_trace=str(trace),
                   log_dir=str(tmp_path / "logs"), device="cpu")
    assert out["episodes"] == 2 and out["intrinsic_trace_len"] == 24
    assert np.isfinite(out["mean_return"]) and trace.exists()
    # playback with the frames drawn (utils/renderer.py), headless
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg")
    out = evaluate(cfg, render=True, log_dir=str(tmp_path / "logs"), device="cpu")
    assert out["episodes"] == 1


def _cli(args, cwd):
    """The CLI started in a subprocess (no GPU visible); ``.communicate()``
    waits for it."""
    env = dict(os.environ, PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    return subprocess.Popen([sys.executable, "-m", "eavit_tpu_torch", *args], cwd=cwd,
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def test_cli_trains_on_cpu_and_refuses_a_silent_cpu_run(tmp_path):
    common = ["--train", "--config_path", str(REPO / "configs" / "synthetic_demo.conf"),
              "--debug_params", "--total_updates", "2", "--log_name", "cli",
              "--save_model_path", str(tmp_path / "ck")]
    (tmp_path / "bad").mkdir()
    # both runs at once: each is mostly interpreter and import start-up
    ok, bad = _cli(common + ["--device", "cpu"], tmp_path), _cli(common, tmp_path / "bad")
    ok_out, ok_err = ok.communicate(timeout=300)
    bad_out, bad_err = bad.communicate(timeout=300)
    assert ok.returncode == 0, ok_err[-2000:]
    assert "update 2 | global_step 128" in ok_out
    assert (tmp_path / "ck" / "cli.pt").exists()
    # no GPU and no --device: a clear error, not a CPU run
    assert bad.returncode != 0
    assert "no CUDA device" in bad_err and "update 1" not in bad_out


def test_unported_run_options_raise(tmp_path):
    byol = dict(ssl_pretraining=True, representation_lr_method=RepresentationMethod.BYOL)
    # the device env and the SSL methods are ported
    # (tests/test_torch_port_device_env.py, tests/test_torch_port_ssl.py): the
    # agent builds for them
    for kw in (dict(env_type=EnvType.SYNTHETIC_DEVICE), byol,
               dict(env_type=EnvType.SYNTHETIC_DEVICE, **byol)):
        build_agent(_cfg(tmp_path, **kw), 5, device="cpu")
    # data parallelism is ported (tests/test_torch_port_dp.py): DataAxisSize
    # must be the number of ranks launched, and this process is one rank
    with pytest.raises(ValueError, match="DataAxisSize = 2 but 1 rank"):
        train(_cfg(tmp_path, data_axis_size=2), total_updates=1, log_dir=str(tmp_path),
              device="cpu")
    # the env stack is ported (tests/test_torch_port_envs.py); a missing
    # emulator raises naming its package, and no other env stands in
    with pytest.raises(ImportError, match="ale_py|gymnasium"):
        train(_cfg(tmp_path, env_type=EnvType.ATARI), total_updates=1,
              log_dir=str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="synthetic_device"):
        make_vector_env(_cfg(tmp_path, env_type=EnvType.SYNTHETIC_DEVICE))


def test_ssl_pretraining_without_a_method_trains_without_ssl(tmp_path):
    """eavit_tpu pretrains only when SSL_pretraining and a method are both set
    (eavit_tpu/train.py:258, :392): the flag alone is no reason to refuse."""
    assert build_agent(_cfg(tmp_path, ssl_pretraining=True), 5, device="cpu").ssl is None
    # with a method too, it pretrains and then trains jointly (Queue 1 item 7)
    cfg = _cfg(tmp_path, ssl_pretraining=True, ssl_pretrain_epochs=1, epoch=1,
               representation_lr_method=RepresentationMethod.BYOL, obs_norm_step=1,
               ssl=port_config.SSLConfig(byol_projection_hidden_size=32,
                                         byol_projection_size=16))
    metrics = train(cfg, total_updates=1, log_dir=str(tmp_path / "logs"), device="cpu")
    assert metrics["train/representation_loss"] > 0.0
    assert all(np.isfinite(v) for v in metrics.values())


def test_render_in_train_raises_until_the_renderer_is_ported(tmp_path):
    """eavit_tpu renders rollout frames (eavit_tpu/train.py:372-376). The
    renderer is ported now (utils/renderer.py, Queue 1 item 11), so ``Render
    = True`` no longer raises; train renders each step's frames."""
    for cfg in (_cfg(tmp_path, render=True), _cfg(tmp_path)):
        assert build_agent(cfg, 5, device="cpu").process_group is None


def test_checkpoint_manager_schedule_and_best(tmp_path):
    cfg = _cfg(tmp_path)
    agent = RNDAgent(cfg, 5, device="cpu")
    state = agent.init_state(0)
    mgr = CheckpointManager(str(tmp_path / "m"), "run", save_every=3)
    assert mgr.maybe_save(agent, state, 1, {"a": 1}) == {}
    first = mgr.maybe_save(agent, state, 2, lambda: {"a": 2}, mean_rollout_reward=0.5,
                           mean_episode_return=1.0)
    assert set(first) == {"rollout_reward", "episode_return"}
    assert set(mgr.maybe_save(agent, state, 3, {}, mean_rollout_reward=0.4)) == {"scheduled"}
    meta = json.loads((tmp_path / "m" / "run.json").read_text())
    assert meta["best_metrics"] == {"rollout_reward": 0.5, "episode_return": 1.0,
                                    "ssl_loss": None}
    other = CheckpointManager(str(tmp_path / "m"), "run", save_every=3)
    other.restore_best(meta)
    assert other.maybe_save(agent, state, 4, {}, mean_rollout_reward=0.45) == {}
    assert set(other.maybe_save(agent, state, 5, {}, ssl_loss=0.1)) == {"ssl_loss"}
    assert (tmp_path / "m" / ("run" + BEST_SUFFIXES["ssl_loss"] + ".pt")).exists()


def test_logger_profiles_then_reports_done(tmp_path):
    log = Logger("p", log_dir=str(tmp_path), use_tensorboard=False)
    log.start_profiling(2)
    torch.ones(4).sum()
    assert log.step_profiler() is False
    assert log.step_profiler() is True  # the caller exits now
    assert log.step_profiler() is False
    log.log_scalars({"x": torch.tensor(1.5)})
    log.close()
    assert (tmp_path / "torch_trace" / "p" / "trace.json").exists()
    assert json.loads((tmp_path / "p_scalars.jsonl").read_text()) == {"step": None, "x": 1.5}


# ---------------------------------------------------------------------------
# continuing a JAX run in the port
# ---------------------------------------------------------------------------


def _rollout(seed, t, n, a):
    rng = np.random.default_rng(seed)
    return dict(
        states=rng.integers(0, 256, (t, n, 4, 84, 84), dtype=np.uint8),
        actions=rng.integers(0, a, (t, n)).astype(np.int32),
        rewards=rng.choice([0.0, 1.0, 3.0], (t, n)).astype(np.float32),
        dones=rng.random((t, n)) < 0.2,
        next_obs=rng.integers(0, 256, (t, n, 1, 84, 84), dtype=np.uint8),
        value_ext=rng.standard_normal((t + 1, n)).astype(np.float32),
        value_int=rng.standard_normal((t + 1, n)).astype(np.float32),
        policy=rng.standard_normal((t, n, a)).astype(np.float32),
    )


def test_load_jax_state_continues_a_jax_run():
    t, n, a = 8, 2, 5
    kw = dict(num_env_per_process=n, num_step=t, compute_dtype="float32",
              shared_patch_stream=True, update_proportion=1.0, learning_rate=1e-3,
              stable_eps=1e-3, attention_impl="pallas_qkv", fused_ffn=True, epoch=1,
              mini_batch=1, use_grad_clipping=True, max_grad_norm=0.5)
    tiny = dict(TINY, depth=1, dropout=0.0, emb_dropout=0.0)
    jag = JaxAgent(jax_config.Config(vit=jax_config.ViTConfig(**tiny), **kw), a)
    jst = agent_state(jag, 1)  # drawn with numpy: no init_state to compile
    ros = [_rollout(s, t, n, a) for s in (10, 11)]
    jro = [JaxRollout(**{k: jnp.asarray(v) for k, v in ro.items()}) for ro in ros]
    jst1, _ = jag.update(jst, jro[0], jax.random.PRNGKey(2))
    carried = jax.tree_util.tree_map(np.asarray, jst1)  # before JAX donates jst1
    jst2, jm = jag.update(jst1, jro[1], jax.random.PRNGKey(3))

    pag = RNDAgent(port_config.Config(vit=port_config.ViTConfig(**tiny), **kw), a,
                   device="cpu")
    pag.init_state(0)
    pst1 = load_jax_state(pag, carried)
    assert (pst1.global_update, pst1.global_step) == (1, t * n)
    steps = {float(s["step"]) for s in pag.optimizer.state_dict()["state"].values()}
    assert steps == {1.0}
    pst2, pm = pag.update(
        pst1, Rollout(**{k: torch.from_numpy(np.asarray(v)) for k, v in ros[1].items()}),
        Rng(0, "cpu"))
    assert (pst2.global_update, pst2.global_step) == (2, 2 * t * n)
    np.testing.assert_allclose(float(pm["train/loss"]), float(jm["train/loss"]),
                               rtol=1e-4, atol=1e-5)
    for a_, b_ in zip(pst2.reward_rms, jst2.reward_rms):
        np.testing.assert_allclose(a_.numpy(), np.asarray(b_), rtol=1e-5, atol=1e-5)
    for key, module in (("policy", pag.network), ("rnd_pred", pag.rnd_pred)):
        ref = flax_tree_to_torch(jax.tree_util.tree_map(np.asarray, jst2.params[key]))
        for name, p in module.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), ref[name], rtol=0, atol=2e-5,
                                       err_msg=f"{key}.{name}")


# ---------------------------------------------------------------------------
# the port imports torch, never JAX
# ---------------------------------------------------------------------------

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "chex", "eavit_tpu"}


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_sources_import_nothing_of_jax():
    files = sorted((REPO / "eavit_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 25
    bad = [(str(f.relative_to(REPO)), name) for f in files for name in _imports(f)
           if name.split(".")[0] in FORBIDDEN]
    assert bad == []
    # and importing every module of the port pulls none of them in
    mods = [".".join(f.relative_to(REPO).with_suffix("").parts) for f in files
            if f.name not in ("__main__.py", "__init__.py", "chip_smoke.py")]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            f"print(sorted(set(sys.modules) & set({sorted(FORBIDDEN)!r})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"
