"""Work of the RND pair over the last raw frame (``original_RND``): three
VALID convolutions (8x8/4 -> 32, 4x4/2 -> 64, 3x3/1 -> 64), then a single
512-wide Dense for the target and three for the predictor, all float32."""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

from benchmark.work._ops import Op, conv, dense


def _trunk(prefix: str, frame: Tuple[int, int], input_grad: bool) -> Tuple[List[Op], int]:
    h, w = frame
    ops, c_in = [], 1
    for i, (k, s, c_out) in enumerate(((8, 4, 32), (4, 2, 64), (3, 1, 64))):
        ho, wo = (h - k) // s + 1, (w - k) // s + 1
        ops.append(conv(f"{prefix}.conv{i + 1}", (ho, wo), c_in, c_out, k, (h, w),
                        input_grad=input_grad and i > 0))
        h, w, c_in = ho, wo, c_out
    return ops, h * w * c_in


def target_ops(hp: Dict[str, Any]) -> List[Op]:
    ops, flat = _trunk("rnd_target", hp["frame"], False)
    return ops + [dense("rnd_target.head", 1, flat, 512, 4)]


def predictor_ops(hp: Dict[str, Any]) -> List[Op]:
    ops, flat = _trunk("rnd_pred", hp["frame"], True)
    return ops + [dense("rnd_pred.head1", 1, flat, 512, 4),
                  dense("rnd_pred.head2", 1, 512, 512, 4),
                  dense("rnd_pred.head3", 1, 512, 512, 4)]
