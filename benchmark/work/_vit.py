"""The dual-token ViT's work per frame, shared by both flavours: the patch
projection, ``depth`` pre-norm blocks in shared-patch-stream mode (two
special tokens and the patches in one sequence) and the actor-critic heads.
LayerNorms, GELU, softmax and the residual adds count as bytes inside the
sublayer they belong to and as no operations."""

from __future__ import annotations

from typing import Any, Dict, List

from benchmark.work._ops import Op, attention, dense, ffn


def policy_ops(hp: Dict[str, Any], qkv_bias: bool, ffn_bytes: int) -> List[Op]:
    grid = hp["image"] // hp["patch"]
    n, tokens = grid * grid, grid * grid + 2
    dim, inner = hp["dim"], hp["heads"] * hp["dim_head"]
    patch_dim = hp["channels"] * hp["patch"] ** 2
    ops = [dense("patch_proj", n, patch_dim, dim, 2, input_grad=False)]
    for i in range(hp["depth"]):
        ops += [
            dense(f"qkv_{i}", tokens, dim, 3 * inner, 2, bias=qkv_bias),
            attention(f"attn_{i}", tokens, hp["heads"], hp["dim_head"], 2),
            dense(f"out_{i}", tokens, inner, dim, 2),
            ffn(f"ffn_{i}", tokens, dim, hp["mlp"], ffn_bytes),
        ]
    ops += [
        dense("actor_fc1", 1, dim, dim, 2),
        dense("actor_fc2", 1, dim, hp["actions"], 2),
        dense("extra_fc.ext", 1, dim, dim, 2),
        dense("extra_fc.int", 1, dim, dim, 2),
        dense("critic_ext", 1, dim, 1, 2),
        dense("critic_int", 1, dim, 1, 2),
    ]
    return ops
