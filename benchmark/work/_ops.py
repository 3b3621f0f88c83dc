"""Operation and byte counts of the algorithm, from shapes alone.

An :class:`Op` is one layer's work per frame: its floating-point operations
in the forward, the bytes of activations it reads and writes per frame, and
the bytes of its weights per call. The counts are the algorithm's, not an
implementation's: every input is read once and every output written once,
whatever a kernel reads again, and nothing is recomputed. A matrix product
of ``m x k`` by ``k x n`` is ``2 m k n`` operations. The backward of a
product is twice its forward (the input's gradient and the weight's), or
once where nothing upstream needs the input's gradient; attention's
backward (dV, dP, dQ, dK) is twice its forward.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, Tuple


@dataclass(frozen=True)
class Op:
    name: str
    group: str  # "attn", "ffn" or "other"
    flops: float  # forward, per frame
    act_in: float  # activation bytes read per frame (forward)
    act_out: float  # activation bytes written per frame (forward)
    weights: float = 0.0  # parameter bytes per call
    input_grad: bool = True  # whether the backward computes the input's gradient
    stats: float = 0.0  # per frame: written by the forward, read by the backward


def dense(name: str, rows: int, n_in: int, n_out: int, act_bytes: int, group: str = "other",
          bias: bool = True, input_grad: bool = True) -> Op:
    """A Dense layer on ``rows`` rows per frame; float32 parameters."""
    return Op(name, group, 2.0 * rows * n_in * n_out, rows * n_in * act_bytes,
              rows * n_out * act_bytes, 4.0 * (n_in * n_out + (n_out if bias else 0)),
              input_grad)


def attention(name: str, tokens: int, heads: int, dim_head: int, act_bytes: int) -> Op:
    """Softmax attention from the raw qkv projection: Q K^T and P V;
    reads qkv, writes the output and the row log-sum-exp (float32)."""
    inner = heads * dim_head
    return Op(name, "attn", 4.0 * heads * tokens * tokens * dim_head,
              3.0 * tokens * inner * act_bytes, tokens * inner * act_bytes,
              stats=4.0 * heads * tokens)


def ffn(name: str, tokens: int, dim: int, hidden: int, act_bytes: int) -> Op:
    """LN -> fc1 -> GELU -> fc2 on ``tokens`` rows; float32 parameters."""
    return Op(name, "ffn", 4.0 * tokens * dim * hidden, tokens * dim * act_bytes,
              tokens * dim * act_bytes, 4.0 * (2 * dim * hidden + hidden + 3 * dim))


def conv(name: str, out_hw: Tuple[int, int], c_in: int, c_out: int, k: int,
         in_hw: Tuple[int, int], input_grad: bool = True) -> Op:
    """A VALID float32 convolution."""
    ho, wo = out_hw
    return Op(name, "other", 2.0 * ho * wo * c_out * c_in * k * k,
              4.0 * in_hw[0] * in_hw[1] * c_in, 4.0 * ho * wo * c_out,
              4.0 * (c_out * c_in * k * k + c_out), input_grad)


def forward(ops: Iterable[Op], frames: float) -> Dict[str, Tuple[float, float]]:
    """``group -> (operations, bytes)`` of one forward call over ``frames``."""
    out: Dict[str, Tuple[float, float]] = {}
    for op in ops:
        f, b = out.get(op.group, (0.0, 0.0))
        out[op.group] = (f + op.flops * frames,
                         b + (op.act_in + op.act_out + op.stats) * frames + op.weights)
    return out


def backward(ops: Iterable[Op], frames: float) -> Dict[str, Tuple[float, float]]:
    """``group -> (operations, bytes)`` of one backward call over ``frames``:
    reads the forward's inputs, outputs and the output's gradient, and the
    weights; writes the input's gradient and the weights' gradients."""
    out: Dict[str, Tuple[float, float]] = {}
    for op in ops:
        f, b = out.get(op.group, (0.0, 0.0))
        mult = 2.0 if (op.input_grad or op.group == "attn") else 1.0
        grad_in = op.act_in if op.input_grad else 0.0
        out[op.group] = (f + op.flops * mult * frames,
                         b + (op.act_in + 2 * op.act_out + op.stats + grad_in) * frames
                         + 2 * op.weights)
    return out


def add(*parts: Dict[str, Tuple[float, float]], scale: float = 1.0) -> Dict[str, Tuple[float, float]]:
    out: Dict[str, Tuple[float, float]] = {}
    for part in parts:
        for g, (f, b) in part.items():
            f0, b0 = out.get(g, (0.0, 0.0))
            out[g] = (f0 + f * scale, b0 + b * scale)
    return out
