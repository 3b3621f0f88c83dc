"""Work of the lucidrains-flavour dual-token ViT (``DualTokenViT``): a
LayerNorm'd patch projection, qkv with no bias, and a float32 residual
stream, so its FFN reads and writes float32 rows."""

from __future__ import annotations

from typing import Any, Dict, List

from benchmark.work._ops import Op
from benchmark.work._vit import policy_ops as _policy_ops


def policy_ops(hp: Dict[str, Any]) -> List[Op]:
    return _policy_ops(hp, qkv_bias=False, ffn_bytes=4)
