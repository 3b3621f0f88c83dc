"""Work of the HF-flavour dual-token ViT (``DualTokenViTHG``): a plain
patch projection, qkv with a bias, and a residual stream in the compute
dtype (bf16), so its FFN reads and writes bf16 rows."""

from __future__ import annotations

from typing import Any, Dict, List

from benchmark.work._ops import Op
from benchmark.work._vit import policy_ops as _policy_ops


def policy_ops(hp: Dict[str, Any]) -> List[Op]:
    return _policy_ops(hp, qkv_bias=True, ffn_bytes=2)
