"""The work model against a hand count, and the calls it assumes against
one iteration of the program on the CPU."""

import pytest
import torch

from benchmark.harness.cell import Job
from benchmark.tests._tiny import tiny
from benchmark.work import dual_token_vit, dual_token_vit_hg, ppo_rnd, rnd_conv
from benchmark.work._ops import backward, forward

torch.set_num_threads(1)

HP = {"image": 12, "patch": 6, "channels": 1, "dim": 8, "heads": 2, "dim_head": 4, "mlp": 16,
      "depth": 1, "actions": 3, "frame": (84, 84), "num_envs": 2, "num_step": 3, "epoch": 1,
      "mini_batch": 2}


def test_policy_forward_by_hand():
    # 4 patches of 36 features, 6 tokens, dim 8, 2 heads of 4, MLP 16, 3 actions
    hand = {"patch_proj": 2 * 4 * 36 * 8, "qkv_0": 2 * 6 * 8 * 24, "attn_0": 4 * 2 * 36 * 4,
            "out_0": 2 * 6 * 8 * 8, "ffn_0": 4 * 6 * 8 * 16, "actor_fc1": 2 * 8 * 8,
            "actor_fc2": 2 * 8 * 3, "extra_fc.ext": 2 * 8 * 8, "extra_fc.int": 2 * 8 * 8,
            "critic_ext": 2 * 8, "critic_int": 2 * 8}
    for arch in (dual_token_vit, dual_token_vit_hg):
        assert {op.name: op.flops for op in arch.policy_ops(HP)} == hand
    assert sum(hand.values()) == 10064


def test_attention_group_of_an_iteration_by_hand():
    # per frame: 1,152 operations; reads qkv 3*6*8*2 = 288 bytes, writes o
    # 6*8*2 = 96 and the lse 4*2*6 = 48. 4 acts of 2 frames; 2 minibatch
    # steps of 3 frames, each forward and backward (twice the operations;
    # reads qkv, o, the lse and dO, writes dqkv: 288 + 96 + 48 + 96 + 288 = 816
    # per frame)
    flops, nbytes = ppo_rnd.iteration(dual_token_vit, HP)["attn"]
    assert flops == 4 * 2 * 1152 + 2 * (3 * 1152 + 3 * 2 * 1152)
    assert nbytes == 4 * 2 * 432 + 2 * (3 * 432 + 3 * 816)


def test_ffn_bytes_follow_the_residual_dtype():
    lucid = forward(dual_token_vit.policy_ops(HP), 1)["ffn"][1]
    hg = forward(dual_token_vit_hg.policy_ops(HP), 1)["ffn"][1]
    weights = 4 * (2 * 8 * 16 + 16 + 3 * 8)
    assert lucid - weights == 2 * (hg - weights) == 2 * 6 * 8 * 4


def test_rnd_trunk_by_hand():
    ops = {op.name: op.flops for op in rnd_conv.target_ops(HP)}
    assert ops == {"rnd_target.conv1": 2 * 20 * 20 * 32 * 64, "rnd_target.conv2":
                   2 * 9 * 9 * 64 * 32 * 16, "rnd_target.conv3": 2 * 7 * 7 * 64 * 64 * 9,
                   "rnd_target.head": 2 * 3136 * 512}
    pred = rnd_conv.predictor_ops(HP)
    # the first conv's input (the frame) needs no gradient
    assert backward(pred[:1], 1)["other"][0] == pred[0].flops


@pytest.mark.parametrize("name", ["flagship.host_env", "hg.host_env", "flagship.device_env"])
def test_one_iteration_calls_what_the_work_model_assumes(name, monkeypatch):
    from eavit_tpu_torch.ops import flash_qkv, fused_ffn

    job = Job(tiny(name), 17, "cpu")
    job.build()
    job.warm_up_obs_norm()
    seen = {"attn_fwd": 0, "attn_bwd": 0, "ffn_fwd": 0, "ffn_bwd": 0}

    def counted(key, fn):
        def wrapper(*a, **k):
            seen[key] += 1
            return fn(*a, **k)
        return wrapper

    monkeypatch.setattr(flash_qkv, "flash_qkv_fwd", counted("attn_fwd", flash_qkv.flash_qkv_fwd))
    monkeypatch.setattr(flash_qkv, "flash_qkv_bwd", counted("attn_bwd", flash_qkv.flash_qkv_bwd))
    monkeypatch.setattr(fused_ffn, "fused_ffn_fwd", counted("ffn_fwd", fused_ffn.fused_ffn_fwd))
    monkeypatch.setattr(fused_ffn, "fused_ffn_bwd", counted("ffn_bwd", fused_ffn.fused_ffn_bwd))
    job.iterate()
    assert seen == ppo_rnd.calls(job.hp)
    job.close()
