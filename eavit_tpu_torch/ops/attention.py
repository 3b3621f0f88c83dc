"""Multi-head attention, plain torch path, and the 16-bit dropout.

Counterpart of ``eavit_tpu/ops/attention.py``:

- :func:`dual_query_allowed` (lines 46-53): the dual-query shared-KV mask.
  With ``num_special`` special tokens first in the sequence, patch rows
  attend only to patch columns and special row ``i`` attends to itself and
  the patches, never to the other special tokens.
- :func:`mha` (lines 56-108): ``softmax(q k^T * scale) v`` on
  ``[B, H, N, Dh]``. ``impl="xla"`` runs the plain path with f32 scores,
  probabilities cast to ``v``'s dtype (``_softmax_cast``, lines 111-135),
  optional 16-bit probability dropout, and the product in ``v``'s dtype.
  ``impl="pallas"`` runs the flash kernels: ``ops/flash_dropout`` (K3)
  while dropout is live, with the two seed words of the call, else
  ``ops/flash`` (K4). ``impl="pallas_stream"`` runs the KV-streaming
  kernels of ``ops/flash_stream`` (K5), which drop no probabilities: a
  dropout rate raises there, and the model drops the attention output.
- :func:`dropout16` (lines 157-196): dropout from 16-bit random integers,
  keep probability ``thresh / 65536`` with the exact inverse scale, drawn
  from an explicit ``torch.Generator`` on the tensor's device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

_NEG_INF = torch.finfo(torch.float32).min


def dual_query_allowed(
    n_rows: int, n_cols: int, num_special: int, device=None
) -> torch.Tensor:
    """[n_rows, n_cols] bool mask of allowed attention edges (module doc)."""
    r = torch.arange(n_rows, device=device)[:, None]
    c = torch.arange(n_cols, device=device)[None, :]
    s = num_special
    patch_patch = (r >= s) & (c >= s)
    token_rows = (r < s) & ((c == r) | (c >= s))
    return patch_patch | token_rows


def dropout16(
    x: torch.Tensor, rate: float, gen: torch.Generator
) -> torch.Tensor:
    """Elementwise dropout with a 16-bit keep threshold; ``E[out] = x``."""
    thresh = int(round((1.0 - rate) * 65536))
    if thresh >= 65536:
        return x
    keep_p = thresh / 65536.0
    bits = torch.randint(
        0, 65536, x.shape, generator=gen, device=x.device, dtype=torch.int32
    )
    return torch.where(bits < thresh, x / keep_p, torch.zeros_like(x)).to(x.dtype)


def mha(
    q: torch.Tensor,  # [B, H, N, Dh]
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
    num_special: int = 0,
    dropout_rate: float = 0.0,
    gen: Optional[torch.Generator] = None,
    impl: str = "xla",
    seeds: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """Softmax attention -> ``[B, H, N, Dh]`` in ``v``'s dtype. Dropout
    draws from ``gen`` on the ``xla`` path and from ``seeds`` on the
    ``pallas`` path; without them the forward is deterministic."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if impl == "pallas":
        # imported here: both kernel modules import this one
        if dropout_rate > 0.0 and seeds is not None:
            from eavit_tpu_torch.ops.flash_dropout import flash_attention_dropout

            return flash_attention_dropout(q, k, v, seeds, dropout_rate, scale=scale,
                                           num_special=num_special)
        from eavit_tpu_torch.ops.flash import flash_attention

        return flash_attention(q, k, v, scale=scale, num_special=num_special)
    if impl == "pallas_stream":
        if dropout_rate > 0.0:
            # eavit_tpu/ops/attention.py:90-95 computes none on this impl
            raise ValueError("attention impl pallas_stream drops no probabilities "
                             f"(dropout_rate={dropout_rate}); its callers drop the "
                             "attention output instead")
        from eavit_tpu_torch.ops.flash_stream import flash_attention_stream

        return flash_attention_stream(q, k, v, scale=scale, num_special=num_special)
    if impl != "xla":
        raise ValueError(f"unknown attention impl: {impl!r}")
    dots = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if num_special:
        allowed = dual_query_allowed(q.shape[2], k.shape[2], num_special, q.device)
        dots = dots.masked_fill(~allowed, _NEG_INF)
    attn = torch.softmax(dots, dim=-1).to(v.dtype)
    if dropout_rate > 0.0 and gen is not None:
        attn = dropout16(attn, dropout_rate, gen)
    return torch.matmul(attn, v)
