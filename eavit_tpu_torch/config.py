"""Configuration system: typed dataclass + reference-compatible ``.conf`` loader.

The port's own copy of ``eavit_tpu/config.py`` (lines 1-587): the same
:class:`Config` dataclass, the same ``.conf`` key map and the same
``config_from_args``, so every file in ``configs/`` loads into an equal
object in both packages. The port imports nothing of ``eavit_tpu``.

Keys that name TPU choices are still parsed. :func:`attention_route` and
:func:`ffn_route` map them onto the port's own choices:

- ``AttentionImpl = pallas_qkv`` runs the CUDA kernel of
  ``ops/flash_qkv.py``; ``pallas`` (or empty with
  ``UsePallasAttention = True``) those of ``ops/flash.py`` and
  ``ops/flash_dropout.py``; ``xla`` (or empty with
  ``UsePallasAttention = False``) the plain path of ``ops/attention.py``;
  ``pallas_stream`` the KV-streaming kernels of ``ops/flash_stream.py``.
- ``FusedFFN = true`` runs the CUDA kernel of ``ops/fused_ffn.py``.
- ``ComputeDtype`` keeps its meaning (the dtype of the Dense layers).
- ``PrngImpl`` is parsed and not read. ``EncoderRemat = full | dots``
  recomputes the encoder's sublayers in the backward (``models/vit.py``).
  ``DataAxisSize`` is the number of data-parallel ranks, one process per
  device as ``torchrun`` launches them: 0 means every launched rank, any
  other value must equal their number (``parallel/dp.py``).

Divergences from the reference (documented, intentional):

- ``UpdateProportion`` is honored. The reference documents it but never
  reads it; the RND masking proportion there is the hard-coded constructor
  default 0.25 (reference agents.py:46 vs utils.py:596).
- ``ProProcWidth`` (reference typo) is accepted as an alias of the
  corrected ``PreProcWidth``.
- ``ViTHG_PreProcHeight`` / ``ViTHG_StateStackSize`` default to
  ``PreProcHeight`` / ``StateStackSize`` when absent; the reference
  KeyErrors on its own shipped configs (reference model.py:213,215).
"""

from __future__ import annotations

import argparse
import configparser
import dataclasses
import json
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Dict, List, Optional, Tuple


class TrainMethod(str, Enum):
    PPO = "PPO"
    ORIGINAL_RND = "original_RND"
    MODIFIED_RND = "modified_RND"


class RepresentationMethod(str, Enum):
    NONE = "None"
    BYOL = "BYOL"
    BARLOW_TWINS = "Barlow-Twins"


class EnvType(str, Enum):
    ATARI = "atari"
    MARIO = "mario"
    CLASSIC_CONTROL = "classic_control"
    SYNTHETIC = "synthetic"  # deterministic procedural env (tests / benches)
    SYNTHETIC_DEVICE = "synthetic_device"  # jittable on-device env (zero-host rollouts)


class ViTImplementation(int, Enum):
    """Backbone selector (reference model.py:16-18)."""

    LUCIDRAINS = 0
    HG = 1


@dataclass(frozen=True)
class ViTConfig:
    """Dual-token ViT backbone hyperparameters (reference vit.py:93-133)."""

    use_explorative_attn: bool = True
    dim: int = 256
    patch_size: int = 6
    num_classes: int = -1  # -1 => no classification head (reference vit.py:131)
    depth: int = 3
    heads: int = 8
    mlp_dim: int = 1024
    dropout: float = 0.1
    emb_dropout: float = 0.1
    dim_head: int = 32


@dataclass(frozen=True)
class ViTHGConfig:
    """HF-style ViT variant hyperparameters (reference vit_hg.py:227-402).

    The TPU build implements this as a second architecture flavor of the same
    dual-token ViT family: post-embedding dropout, GELU intermediate, qkv
    bias, separate per-stream encoder semantics, trunc-normal init.
    """

    use_explorative_attn: bool = True
    hidden_size: int = 1024
    num_hidden_layers: int = 12
    num_attention_heads: int = 16
    intermediate_size: int = 3072
    hidden_dropout_prob: float = 0.0
    attention_probs_dropout_prob: float = 0.0
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-12
    patch_size: int = 12
    qkv_bias: bool = True
    encoder_stride: int = 16
    # Reference reads these two from keys missing in every shipped .conf
    # (model.py:213,215); we default them from the global preprocessing keys.
    image_size: Optional[int] = None
    num_channels: Optional[int] = None


@dataclass(frozen=True)
class SSLConfig:
    """BYOL / Barlow-Twins options (reference BYOL.py, BarlowTwins.py)."""

    apply_same_transform_to_batch: bool = False
    byol_projection_hidden_size: int = 4096
    byol_projection_size: int = 256
    byol_moving_average_decay: float = 0.99
    byol_representation_loss_coef: float = 0.01
    barlow_twins_lambda: float = 0.0051
    barlow_twins_projection_sizes: Tuple[int, ...] = (8192, 8192, 8192)
    barlow_twins_representation_loss_coef: float = 0.01


@dataclass(frozen=True)
class Config:
    """Full experiment configuration.

    Field-by-field mirror of the reference's ~60 documented ``.conf`` keys
    (reference utils.py:559-641) plus TPU-native additions at the bottom.
    """

    # --- modes -----------------------------------------------------------
    train_method: TrainMethod = TrainMethod.ORIGINAL_RND
    representation_lr_method: RepresentationMethod = RepresentationMethod.NONE
    ssl_pretraining: bool = False
    freeze_shared_backbone: bool = False

    # --- environment ------------------------------------------------------
    env_type: EnvType = EnvType.ATARI
    env_id: str = "MontezumaRevengeNoFrameskip-v4"
    max_step_per_episode: int = 4500
    life_done: bool = False
    state_stack_size: int = 4
    sticky_action: bool = True
    action_prob: float = 0.25  # sticky-action probability
    pre_proc_height: int = 84
    pre_proc_width: int = 84
    # Pre-clip reward scaling (TPU-repo extension). The update clips
    # extrinsic rewards to [-1, 1] (reference train.py:708); dense-reward
    # continuous tasks like Pendulum-v1 (per-step reward in [-16.27, 0])
    # would lose nearly all signal to that clip. The reference solves the
    # same problem for Mario by dividing its reward by 15 (envs.py:421);
    # this key generalizes that: reward *= RewardScale before the stack.
    reward_scale: float = 1.0

    # --- PPO / RND --------------------------------------------------------
    epoch: int = 4
    mini_batch: int = 32
    # merge m consecutive minibatches into ONE optimizer step of
    # m*batch_size samples (same epoch/sample budget, fewer and larger
    # steps): a documented divergence knob, not the parity default
    minibatch_merge: int = 1
    # encoder rematerialization in the update's backward: "none" | "full" |
    # "dots" (eavit_tpu/config.py:161-168), models/vit.py Transformer
    encoder_remat: str = "none"
    learning_rate: float = 1e-4
    ppo_eps: float = 0.1
    entropy_coef: float = 0.001
    num_step: int = 128
    int_gamma: float = 0.99
    gamma: float = 0.999
    ext_coef: float = 2.0
    int_coef: float = 1.0
    update_proportion: float = 0.25
    use_gae: bool = True
    gae_lambda: float = 0.95
    obs_norm_step: int = 50
    use_noisy_net: bool = False
    stable_eps: float = 1e-8
    use_grad_clipping: bool = False
    max_grad_norm: float = 0.5

    # --- backbone ---------------------------------------------------------
    extracted_feature_embedding_dim: int = 448
    vit_implementation_type: ViTImplementation = ViTImplementation.LUCIDRAINS
    vit: ViTConfig = field(default_factory=ViTConfig)
    vit_hg: ViTHGConfig = field(default_factory=ViTHGConfig)

    # --- SSL ----------------------------------------------------------------
    ssl: SSLConfig = field(default_factory=SSLConfig)

    # --- run control --------------------------------------------------------
    load_model: bool = False
    render: bool = False
    save_ckpt_every: int = 100
    verbose_logging: bool = False
    use_gpu: bool = True  # reference key; here: "use accelerator"

    # --- runtime (CLI-provided in reference, argument_parser.py:14-28) ------
    seed: int = 42
    num_env_per_process: int = 64
    log_name: str = "eavit"
    load_model_path: Optional[str] = None
    save_model_path: str = "checkpoints"
    use_wandb: bool = False

    # --- keys added by the JAX package (eavit_tpu/config.py:210-280) -------
    # Attention and FFN implementation names; attention_route / ffn_route
    # below map them onto the port's kernels and plain paths.
    use_pallas_attention: bool = False
    fused_ffn: bool = False
    # "xla" | "pallas" | "pallas_stream" | "pallas_qkv"; empty = derive
    # from use_pallas_attention
    attention_impl: str = ""
    # Fused dual-query shared-KV mode (SURVEY §5): one masked sequence
    # [tok_explore, tok_exploit, patches] instead of a 2B token-stream stack —
    # halves encoder FLOPs; patches become a token-independent shared trunk
    # (CaiT-class-attention-style semantic variant, params identical).
    shared_patch_stream: bool = False
    compute_dtype: str = "bfloat16"  # dtype of the Dense layers
    prng_impl: str = "rbg"  # JAX generator name; parsed, not read by the port
    data_axis_size: int = 1  # data-parallel ranks (0: every launched rank)
    # threaded env pool with half-fleet double-buffered rollouts in the JAX
    # package (eavit_tpu/rl/device_rollout.py); parsed, not read by the port
    async_env_pool: bool = False
    total_updates: int = -1  # -1 = run forever (reference train.py:580)
    synthetic_grid: int = 8  # room-grid side length of the synthetic env
    # DFS spanning-tree maze walls for the synthetic/device env (hard-
    # exploration regime where random walks stall; envs/device_env.py)
    synthetic_maze: bool = False
    # room-frame family: "sine" (smooth, host-env bit-exact) or "noise"
    # (mutually unpredictable rooms — the Montezuma-like novelty regime)
    synthetic_texture: str = "sine"
    # all envs share ONE world (textures + maze), like N parallel actors in
    # one Atari game — the reference's actual setting
    synthetic_shared_world: bool = False
    # frame variants per room, shown as steps % V (Montezuma-like frame
    # variety: RND novelty decays with visitation count, not on first sight)
    synthetic_variants: int = 1
    # sparse-goal mode for the device env: reward ONLY at the BFS-farthest
    # room (terminates the episode) instead of dense first-visit rewards —
    # the Montezuma-shaped regime where extrinsic-only PPO flounders and
    # intrinsic exploration is required (envs/device_env.py)
    synthetic_sparse_goal: bool = False
    # sparse-goal placement: 0 = BFS-farthest room (round-3 semantics);
    # >0 = the reachable room whose BFS depth is closest to this target —
    # direct control of sparse-reward difficulty (envs/device_env.py)
    synthetic_goal_depth: int = 0
    # linearly anneal the intrinsic-advantage coefficient to 0 over this
    # many updates (0 = constant int_coef, the reference behavior,
    # agents.py:472). Annealing lets the extrinsic gradient take over once
    # exploration has surfaced the sparse reward (RND paper app. A.4 uses
    # a related two-head discount split).
    int_coef_decay_updates: int = 0
    # SSL pretraining epoch budget, independent of total_updates (-1 = run
    # forever, like the reference's while-True SSL loop, train.py:342)
    ssl_pretrain_epochs: int = -1
    # eval episode budget (-1 = run forever, reference eval.py:198)
    eval_episodes: int = -1

    # ------------------------------------------------------------------
    @property
    def num_worker(self) -> int:
        return self.num_env_per_process

    @property
    def batch_size(self) -> int:
        """PPO minibatch size (reference train.py:111)."""
        return int(self.num_step * self.num_env_per_process / self.mini_batch)

    @property
    def backbone_dim(self) -> int:
        if self.vit_implementation_type == ViTImplementation.LUCIDRAINS:
            return self.vit.dim
        return self.vit_hg.hidden_size

    @property
    def use_explorative_attn(self) -> bool:
        if self.vit_implementation_type == ViTImplementation.LUCIDRAINS:
            return self.vit.use_explorative_attn
        return self.vit_hg.use_explorative_attn

    def replace(self, **kw: Any) -> "Config":
        return dataclasses.replace(self, **kw)

    def with_debug_params(self) -> "Config":
        """Shrink the workload for smoke tests (reference config.py:5-11)."""
        return self.replace(num_step=16, obs_norm_step=5, num_env_per_process=4)


# ---------------------------------------------------------------------------
# mapping of the TPU keys onto the port's implementations
# ---------------------------------------------------------------------------

# What each attention implementation runs: "kernel" is the CUDA kernel of
# ops/flash_qkv.py, "flash" those of ops/flash.py and ops/flash_dropout.py,
# "stream" those of ops/flash_stream.py, "plain" the torch path of
# ops/attention.py.
_ATTENTION_ROUTES = {"pallas_qkv": "kernel", "pallas": "flash",
                     "pallas_stream": "stream", "xla": "plain"}


def attention_route(cfg: Config) -> str:
    """The attention implementation a model built from ``cfg`` runs:
    ``"kernel"`` (``AttentionImpl = pallas_qkv``), ``"flash"`` (``pallas``),
    ``"stream"`` (``pallas_stream``) or ``"plain"`` (``xla``). The empty name
    derives from ``UsePallasAttention`` as in
    ``eavit_tpu/models/policy.py:56-58``."""
    impl = cfg.attention_impl or ("pallas" if cfg.use_pallas_attention else "xla")
    if impl not in _ATTENTION_ROUTES:
        raise ValueError(f"unknown attention impl: {impl!r}")
    return _ATTENTION_ROUTES[impl]


def ffn_route(cfg: Config) -> str:
    """``"kernel"`` (``FusedFFN = true``: ops/fused_ffn.py) or ``"plain"``."""
    return "kernel" if cfg.fused_ffn else "plain"


# ---------------------------------------------------------------------------
# .conf loading (reference-compatible)
# ---------------------------------------------------------------------------

_BOOL = configparser.ConfigParser.BOOLEAN_STATES


def _as_bool(v: str) -> bool:
    try:
        return _BOOL[v.strip().lower()]
    except KeyError:
        raise ValueError(f"not a boolean: {v!r}")


# INI key -> (path into Config, parser)
_KEYMAP: Dict[str, Tuple[Tuple[str, ...], Any]] = {
    "SSL_pretraining": (("ssl_pretraining",), _as_bool),
    "freeze_shared_backbone": (("freeze_shared_backbone",), _as_bool),
    # "RND" is the legacy spelling of original_RND used by the reference's
    # old_configs/ tree.
    "TrainMethod": (
        ("train_method",),
        lambda v: TrainMethod("original_RND" if v == "RND" else v),
    ),
    "representationLearningMethod": (("representation_lr_method",), RepresentationMethod),
    "EnvType": (("env_type",), EnvType),
    "EnvID": (("env_id",), str),
    "Epoch": (("epoch",), int),
    "MiniBatch": (("mini_batch",), int),
    "MiniBatchMerge": (("minibatch_merge",), int),
    "LearningRate": (("learning_rate",), float),
    "extracted_feature_embedding_dim": (("extracted_feature_embedding_dim",), int),
    "ViT_implementation_type": (("vit_implementation_type",), lambda v: ViTImplementation(int(v))),
    "ViTlucidrains_use_explorativeAttn": (("vit", "use_explorative_attn"), _as_bool),
    "ViTlucidrains_dim": (("vit", "dim"), int),
    "ViTlucidrains_patch_size": (("vit", "patch_size"), int),
    "ViTlucidrains_num_classes": (("vit", "num_classes"), int),
    "ViTlucidrains_depth": (("vit", "depth"), int),
    "ViTlucidrains_heads": (("vit", "heads"), int),
    "ViTlucidrains_mlp_dim": (("vit", "mlp_dim"), int),
    "ViTlucidrains_dropout": (("vit", "dropout"), float),
    "ViTlucidrains_emb_dropout": (("vit", "emb_dropout"), float),
    "ViTlucidrains_dim_head": (("vit", "dim_head"), int),
    "ViTHG_use_explorativeAttn": (("vit_hg", "use_explorative_attn"), _as_bool),
    "ViTHG_hidden_size": (("vit_hg", "hidden_size"), int),
    "ViTHG_num_hidden_layers": (("vit_hg", "num_hidden_layers"), int),
    "ViTHG_num_attention_heads": (("vit_hg", "num_attention_heads"), int),
    "ViTHG_intermediate_size": (("vit_hg", "intermediate_size"), int),
    "ViTHG_hidden_dropout_prob": (("vit_hg", "hidden_dropout_prob"), float),
    "ViTHG_attention_probs_dropout_prob": (("vit_hg", "attention_probs_dropout_prob"), float),
    "ViTHG_initializer_range": (("vit_hg", "initializer_range"), float),
    "ViTHG_layer_norm_eps": (("vit_hg", "layer_norm_eps"), float),
    "ViTHG_patch_size": (("vit_hg", "patch_size"), int),
    "ViTHG_qkv_bias": (("vit_hg", "qkv_bias"), _as_bool),
    "ViTHG_encoder_stride": (("vit_hg", "encoder_stride"), int),
    "ViTHG_PreProcHeight": (("vit_hg", "image_size"), int),
    "ViTHG_StateStackSize": (("vit_hg", "num_channels"), int),
    "PPOEps": (("ppo_eps",), float),
    "Entropy": (("entropy_coef",), float),
    "NumStep": (("num_step",), int),
    "MaxStepPerEpisode": (("max_step_per_episode",), int),
    "LifeDone": (("life_done",), _as_bool),
    "StateStackSize": (("state_stack_size",), int),
    "StickyAction": (("sticky_action",), _as_bool),
    "ActionProb": (("action_prob",), float),
    "RewardScale": (("reward_scale",), float),
    "EncoderRemat": (("encoder_remat",), str),
    "IntGamma": (("int_gamma",), float),
    "Gamma": (("gamma",), float),
    "ExtCoef": (("ext_coef",), float),
    "IntCoef": (("int_coef",), float),
    "UpdateProportion": (("update_proportion",), float),
    "UseGAE": (("use_gae",), _as_bool),
    "GAELambda": (("gae_lambda",), float),
    "PreProcHeight": (("pre_proc_height",), int),
    "PreProcWidth": (("pre_proc_width",), int),
    "ProProcWidth": (("pre_proc_width",), int),  # reference typo, kept as alias
    "ObsNormStep": (("obs_norm_step",), int),
    "UseNoisyNet": (("use_noisy_net",), _as_bool),
    "apply_same_transform_to_batch": (("ssl", "apply_same_transform_to_batch"), _as_bool),
    "BYOL_projectionHiddenSize": (("ssl", "byol_projection_hidden_size"), int),
    "BYOL_projectionSize": (("ssl", "byol_projection_size"), int),
    "BYOL_movingAverageDecay": (("ssl", "byol_moving_average_decay"), float),
    "BYOL_representationLossCoef": (("ssl", "byol_representation_loss_coef"), float),
    "BarlowTwinsLambda": (("ssl", "barlow_twins_lambda"), float),
    "BarlowTwinsProjectionSizes": (
        ("ssl", "barlow_twins_projection_sizes"),
        lambda v: tuple(json.loads(v)),
    ),
    "BarlowTwins_representationLossCoef": (("ssl", "barlow_twins_representation_loss_coef"), float),
    "loadModel": (("load_model",), _as_bool),
    "render": (("render",), _as_bool),
    "saveCkptEvery": (("save_ckpt_every",), int),
    "verbose_logging": (("verbose_logging",), _as_bool),
    "StableEps": (("stable_eps",), float),
    "UseGPU": (("use_gpu",), _as_bool),
    "UseGradClipping": (("use_grad_clipping",), _as_bool),
    "MaxGradNorm": (("max_grad_norm",), float),
    # TPU-native keys (absent in reference configs; loadable from new configs)
    "UsePallasAttention": (("use_pallas_attention",), _as_bool),
    "FusedFFN": (("fused_ffn",), _as_bool),
    "AttentionImpl": (("attention_impl",), str),
    "SharedPatchStream": (("shared_patch_stream",), _as_bool),
    "ComputeDtype": (("compute_dtype",), str),
    "PrngImpl": (("prng_impl",), str),
    "DataAxisSize": (("data_axis_size",), int),
    "AsyncEnvPool": (("async_env_pool",), _as_bool),
    "TotalUpdates": (("total_updates",), int),
    "Seed": (("seed",), int),
    "SyntheticGrid": (("synthetic_grid",), int),
    "SyntheticMaze": (("synthetic_maze",), _as_bool),
    "SyntheticTexture": (("synthetic_texture",), str),
    "SyntheticSharedWorld": (("synthetic_shared_world",), _as_bool),
    "SyntheticVariants": (("synthetic_variants",), int),
    "SyntheticSparseGoal": (("synthetic_sparse_goal",), _as_bool),
    "SyntheticGoalDepth": (("synthetic_goal_depth",), int),
    "IntCoefDecayUpdates": (("int_coef_decay_updates",), int),
    "SSLEpochs": (("ssl_pretrain_epochs",), int),
    "EvalEpisodes": (("eval_episodes",), int),
}


def _set_path(tree: Dict[str, Any], path: Tuple[str, ...], value: Any) -> None:
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


def load_config(
    path: Optional[str] = None,
    overrides: Optional[Dict[str, Any]] = None,
    strict: bool = True,
) -> Config:
    """Load a reference-format ``.conf`` file into a :class:`Config`.

    ``overrides`` are snake_case dataclass-field overrides applied last
    (flat for top-level fields; dotted ``vit.dim`` style for nested ones).
    With ``strict`` unknown INI keys raise; otherwise they are ignored.
    """
    tree: Dict[str, Any] = {}
    if path is not None:
        parser = configparser.ConfigParser()
        read = parser.read(path)
        if not read:
            raise FileNotFoundError(path)
        for key, raw in parser["DEFAULT"].items():
            # configparser lowercases keys; match case-insensitively.
            match = next((k for k in _KEYMAP if k.lower() == key.lower()), None)
            if match is None:
                if strict:
                    raise KeyError(f"unknown config key in {path}: {key}")
                continue
            fieldpath, parse = _KEYMAP[match]
            _set_path(tree, fieldpath, parse(raw))

    for key, value in (overrides or {}).items():
        _set_path(tree, tuple(key.split(".")), value)

    return _build(Config, tree)


def _build(cls: type, tree: Dict[str, Any]) -> Any:
    kwargs: Dict[str, Any] = {}
    for f in dataclasses.fields(cls):
        if f.name not in tree:
            continue
        v = tree[f.name]
        if isinstance(v, dict):
            sub_cls = {"vit": ViTConfig, "vit_hg": ViTHGConfig, "ssl": SSLConfig}[f.name]
            base = dataclasses.asdict(sub_cls())
            base.update(v)
            v = sub_cls(**{k: base[k] for k in base})
        kwargs[f.name] = v
    return cls(**kwargs)


# ---------------------------------------------------------------------------
# CLI (reference argument_parser.py:5-40)
# ---------------------------------------------------------------------------


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="eavit_tpu_torch",
        description="Explorative-Attention ViT RND/PPO framework (PyTorch/CUDA port)",
    )
    # default None so a config file's Seed key is only overridden when the
    # flag is passed explicitly (the effective default stays 42)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--config_path", type=str, default=None)
    p.add_argument("--log_name", type=str, default="eavit")
    p.add_argument("--train", action="store_true", default=False)
    p.add_argument("--eval", action="store_true", default=False)
    p.add_argument("--load_model_path", type=str, default=None)
    p.add_argument("--save_model_path", type=str, default="checkpoints")
    p.add_argument("--num_env_per_process", type=int, default=64)
    p.add_argument("--config_options", action="store_true", default=False)
    p.add_argument("--use_wandb", action="store_true", default=False)
    p.add_argument("--wandb_api_key", type=str, default=None)
    p.add_argument("--debug_params", action="store_true", default=False)
    # accepted for reference-CLI parity
    p.add_argument("--gpu_id", type=int, default=None)
    p.add_argument("--device", type=str, default=None,
                   help="torch device of the run; default: CUDA, and an error "
                        "without a GPU (pass 'cpu' for the plain CPU path)")
    p.add_argument("--profile_updates", type=int, default=0,
                   help="trace this many updates with the profiler then exit "
                        "(reference --pytorch_profiling / --scalene_profiling)")
    # legacy reference flags (argument_parser.py:23-25): N iterations
    # traced, then exit
    p.add_argument("--pytorch_profiling", action="store_true", default=False)
    p.add_argument("--scalene_profiling", type=int, default=0)
    p.add_argument("--total_updates", type=int, default=None,
                   help="stop after N updates (reference runs forever)")
    p.add_argument("--ssl_epochs", type=int, default=None,
                   help="SSL pretraining epochs (-1 = run forever)")
    p.add_argument("--num_episodes", type=int, default=None,
                   help="eval: stop after N episodes (-1 = run forever)")
    p.add_argument("--greedy", action="store_true", default=False,
                   help="eval: argmax/mean actions instead of sampling "
                        "(the reference's eval samples, eval.py:198-299)")
    p.add_argument("--save_intrinsic_trace", type=str, default=None,
                   help="eval: pickle the per-step intrinsic-reward trace "
                        "here (producer for make_animation; reference "
                        "eval.py:286-290 hardcodes int_rewards.pkl)")
    return p


def get_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    """Parse CLI flags, tolerating launcher leftovers (reference
    argument_parser.py:36 uses parse_known_args for torchrun/scalene)."""
    args, _unknown = build_arg_parser().parse_known_args(argv)
    assert args.train ^ args.eval, "exactly one of --train / --eval is required"
    if not args.profile_updates:
        if args.pytorch_profiling:
            args.profile_updates = 3  # reference schedule wait+warmup+active
        elif args.scalene_profiling:
            args.profile_updates = args.scalene_profiling
    return args


def config_from_args(args: argparse.Namespace) -> Config:
    overrides: Dict[str, Any] = {
        "log_name": args.log_name,
        "num_env_per_process": args.num_env_per_process,
        "save_model_path": args.save_model_path,
        "use_wandb": args.use_wandb,
    }
    if args.seed is not None:
        overrides["seed"] = args.seed
    if args.load_model_path:
        overrides["load_model_path"] = args.load_model_path
        overrides["load_model"] = True
    if args.total_updates is not None:
        overrides["total_updates"] = args.total_updates
    if getattr(args, "ssl_epochs", None) is not None:
        overrides["ssl_pretrain_epochs"] = args.ssl_epochs
    if getattr(args, "num_episodes", None) is not None:
        overrides["eval_episodes"] = args.num_episodes
    cfg = load_config(args.config_path, overrides)
    if args.debug_params:
        cfg = cfg.with_debug_params()
    return cfg


def print_config_options() -> str:
    """Human-readable key reference (reference utils.py:559-641)."""
    lines = ["Config keys (INI name -> field, type):"]
    for key, (path, parse) in sorted(_KEYMAP.items()):
        tname = getattr(parse, "__name__", parse.__class__.__name__)
        lines.append(f"  {key:40s} -> {'.'.join(path):50s} ({tname})")
    lines.append(
        "Note: UseGPU is accepted for .conf parity and ignored — the port "
        "runs on CUDA unless the caller passes device='cpu' (reference "
        "utils.py:604)."
    )
    text = "\n".join(lines)
    print(text)
    return text
