"""Dual-token "Explorative Attention" Vision Transformer (lucidrains flavour).

Counterpart of ``eavit_tpu/models/vit.py`` (lines 54-427): a ViT whose CLS
token is replaced by an exploration token and an exploitation token. Two
modes, with identical parameters:

- exact stacked mode (``vit.py:415-422``): each token is prepended to the
  shared patch embedding, the two sequences are stacked along the batch
  ([2B, n+1, dim]) and the encoder runs once;
- shared-patch-stream mode (``vit.py:398-414``): one sequence
  ``[tok_explore, tok_exploit, patches]`` ([B, n+2, dim]) under the
  dual-query mask (``num_special = 2``). Both tokens take position 0
  (``pos[:, :1]``), the patches positions 1..n.

Dtypes follow the JAX package's cast points under a compute dtype: the
Dense layers run in it, the LayerNorms return float32, so the residual
stream, the FFN and the final norm stay float32 while qkv, attention and
the output projection run in the compute dtype.

Implementation routes (``config.attention_route`` / ``ffn_route``):
``"kernel"`` runs ``ops/flash_qkv`` (K1) and ``ops/fused_ffn`` (K2),
``"flash"`` runs ``ops/attention.mha(impl="pallas")`` on the split heads
(K3 while dropout is live, else K4), ``"stream"`` ``mha(impl="pallas_stream")``
(K5, with 16-bit dropout on the attention output while dropout is live, the
JAX package's documented divergence), ``"plain"`` the torch layers. The
modules' parameter names mirror the flax tree (the same on every route), so
``convert.load_jax_params`` maps one onto the other by name.
``DualTokenViTHG`` (vit.py:430-536) is not ported yet.

A forward with ``rng=None`` is deterministic (the JAX ``deterministic=True``);
with an :class:`~eavit_tpu_torch.models.layers.Rng` dropout is live, as at
act time (``eavit_tpu/rl/agent.py:221-243``).

``EncoderRemat`` (``vit.py:267-300``): under ``full`` each ``attn_i`` and
``ff_i`` runs under ``torch.utils.checkpoint`` (non-reentrant) and is
recomputed whole in the backward; under ``dots`` a selective checkpoint
keeps the outputs of torch's matrix products and recomputes the rest, the
kernels included (``jax.checkpoint_policies.dots_saveable``: a Pallas call
is one primitive to JAX, not a dot). A recomputed sublayer takes its seed
words and device draws from a
:class:`~eavit_tpu_torch.models.layers.RecordedRng`, which keeps what the
first run drew and replays it, so the backward sees the first run's masks,
and the stream goes on as under ``none``: both modes give ``none``'s
gradients. The parameter names do not
change, as ``nn.remat`` keeps them. Without autograd (acting, the SSL
target) nothing is checkpointed.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
    noop_context_fn,
)

from eavit_tpu_torch.config import ViTConfig
from eavit_tpu_torch.models.layers import Dense, Dropout16, LayerNorm, Rng
from eavit_tpu_torch.ops.attention import mha
from eavit_tpu_torch.ops.flash_qkv import flash_mha_qkv
from eavit_tpu_torch.ops.fused_ffn import fused_ffn


def patchify(img: torch.Tensor, patch: int) -> torch.Tensor:
    """[B, C, H, W] -> [B, (H/p)*(W/p), p*p*C], features ordered rows,
    columns, then channels fastest (vit.py:54-65)."""
    b, c, h, w = img.shape
    gh, gw = h // patch, w // patch
    x = img.reshape(b, c, gh, patch, gw, patch).permute(0, 2, 4, 3, 5, 1)
    return x.reshape(b, gh * gw, patch * patch * c)


class MultiHeadAttention(nn.Module):
    """Pre-norm MHA (vit.py:68-161)."""

    def __init__(self, dim: int, heads: int, dim_head: int, dropout: float,
                 route: str, num_special: int, dtype: Optional[torch.dtype]) -> None:
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.dropout, self.route, self.num_special = dropout, route, num_special
        self.norm = LayerNorm(dim, eps=1e-5)
        self.to_qkv = Dense(dim, inner * 3, bias=False, dtype=dtype)
        self.project_out = not (heads == 1 and dim_head == dim)
        if self.project_out:
            self.to_out = Dense(inner, dim, dtype=dtype)
        self.out_drop = Dropout16(dropout)

    def forward(self, x: torch.Tensor, rng: Optional[Rng] = None) -> torch.Tensor:
        training = rng is not None and self.dropout > 0.0
        qkv = self.to_qkv(self.norm(x))
        b, n, _ = qkv.shape
        if self.route == "kernel":
            out = flash_mha_qkv(
                qkv, self.heads, self.dim_head,
                seeds=rng.seeds() if training else None,
                rate=self.dropout if training else 0.0,
                num_special=self.num_special,
            )
        else:
            # [B, N, 3*H*Dh] -> q, k, v [B, H, N, Dh]
            heads = qkv.reshape(b, n, 3, self.heads, self.dim_head).permute(2, 0, 3, 1, 4)
            if self.route != "plain":
                # the kernels take contiguous heads: one layout copy, as the
                # JAX package pays at the pallas_call boundary
                heads = heads.contiguous()
            q, k, v = heads
            if self.route == "stream":
                # the KV-streaming kernel drops no probabilities: dropout on
                # the attention output [B, H, N, Dh] instead (vit.py:134-141)
                out = self.out_drop(mha(q, k, v, num_special=self.num_special,
                                        impl="pallas_stream"), rng)
            else:
                flash = self.route == "flash"
                out = mha(q, k, v, num_special=self.num_special,
                          dropout_rate=self.dropout if training else 0.0,
                          gen=rng.device if training and not flash else None,
                          impl="pallas" if flash else "xla",
                          seeds=rng.seeds() if training and flash else None)
            out = out.transpose(1, 2).reshape(b, n, self.heads * self.dim_head)
        if self.project_out:
            out = self.out_drop(self.to_out(out), rng)
        return out


class FeedForward(nn.Module):
    """Pre-norm MLP with exact GELU (vit.py:196-248). The kernel route runs
    the whole sublayer through ``ops/fused_ffn`` in the input's dtype, as the
    JAX fused path does (it ignores the compute dtype)."""

    def __init__(self, dim: int, hidden_dim: int, dropout: float, route: str,
                 dtype: Optional[torch.dtype]) -> None:
        super().__init__()
        self.dropout, self.route = dropout, route
        self.norm = LayerNorm(dim, eps=1e-5)
        self.fc1 = Dense(dim, hidden_dim, dtype=dtype)
        self.fc2 = Dense(hidden_dim, dim, dtype=dtype)
        self.drop = Dropout16(dropout)

    def forward(self, x: torch.Tensor, rng: Optional[Rng] = None) -> torch.Tensor:
        training = rng is not None and self.dropout > 0.0
        if self.route == "kernel":
            return fused_ffn(
                x, self.norm.weight, self.norm.bias, self.fc1.weight, self.fc1.bias,
                self.fc2.weight, self.fc2.bias,
                seeds=rng.seeds() if training else None,
                rate=self.dropout if training else 0.0, eps=self.norm.eps,
            )
        h = F.gelu(self.fc1(self.norm(x)), approximate="none")
        return self.drop(self.fc2(self.drop(h, rng)), rng)


_MATMULS = {torch.ops.aten.mm, torch.ops.aten.addmm, torch.ops.aten.bmm,
             torch.ops.aten.baddbmm}


def _dots_saveable(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """``dots`` remat: keep the matrix products' outputs, recompute the rest."""
    if op.overloadpacket in _MATMULS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


REMAT_MODES = ("none", "full", "dots")


class Transformer(nn.Module):
    """Pre-norm encoder with a final LayerNorm (vit.py:251-310). Layers are
    named ``attn_{i}`` / ``ff_{i}`` as in the flax tree."""

    def __init__(self, dim: int, depth: int, heads: int, dim_head: int,
                 mlp_dim: int, dropout: float, attention_route: str,
                 ffn_route: str, num_special: int,
                 dtype: Optional[torch.dtype], remat: str = "none") -> None:
        super().__init__()
        if remat not in REMAT_MODES:
            raise ValueError(f"EncoderRemat must be one of {REMAT_MODES}, got {remat!r}")
        self.depth, self.remat = depth, remat
        for i in range(depth):
            self.add_module(f"attn_{i}", MultiHeadAttention(
                dim, heads, dim_head, dropout, attention_route, num_special, dtype))
            self.add_module(f"ff_{i}", FeedForward(
                dim, mlp_dim, dropout, ffn_route, dtype))
        self.norm = LayerNorm(dim, eps=1e-5)

    def _rematerialised(self, layer: nn.Module, x: torch.Tensor,
                        rng: Optional[Rng]) -> torch.Tensor:
        """``layer(x, rng)`` under a checkpoint whose recompute replays the
        first run's draws (module doc)."""
        rec = rng.record() if rng is not None and layer.dropout > 0 else None

        def run(x):
            if rec is not None:
                rec.rewind()
            return layer(x, rec)

        context = (functools.partial(create_selective_checkpoint_contexts, _dots_saveable)
                   if self.remat == "dots" else noop_context_fn)
        out = checkpoint(run, x, use_reentrant=False, preserve_rng_state=False,
                         context_fn=context)
        if rec is not None:
            rec.advance()
        return out

    def forward(self, x: torch.Tensor, rng: Optional[Rng] = None) -> torch.Tensor:
        remat = self.remat != "none" and torch.is_grad_enabled()
        for i in range(self.depth):
            for layer in (getattr(self, f"attn_{i}"), getattr(self, f"ff_{i}")):
                x = x + (self._rematerialised(layer, x, rng) if remat else layer(x, rng))
        return self.norm(x)


class DualTokenViT(nn.Module):
    """Lucidrains-flavour dual-token ViT (vit.py:313-427)."""

    def __init__(self, cfg: ViTConfig, image_size: int, channels: int,
                 attention_route: str = "plain", ffn_route: str = "plain",
                 shared_patch_stream: bool = False,
                 dtype: Optional[torch.dtype] = None, remat: str = "none") -> None:
        super().__init__()
        if image_size % cfg.patch_size:
            raise ValueError("Image dimensions must be divisible by the patch size.")
        self.cfg, self.dtype = cfg, dtype
        num_patches = (image_size // cfg.patch_size) ** 2
        patch_dim = channels * cfg.patch_size ** 2
        self.fused = shared_patch_stream and cfg.use_explorative_attn
        # flax nn.LayerNorm() default epsilon 1e-6 (vit.py:351, 359)
        self.patch_norm_in = LayerNorm(patch_dim, eps=1e-6)
        self.patch_proj = Dense(patch_dim, cfg.dim, dtype=dtype)
        self.patch_norm_out = LayerNorm(cfg.dim, eps=1e-6)
        self.pos_embedding = nn.Parameter(torch.empty(1, num_patches + 1, cfg.dim))
        if cfg.use_explorative_attn:
            self.exploration_token = nn.Parameter(torch.empty(1, 1, cfg.dim))
            self.exploitation_token = nn.Parameter(torch.empty(1, 1, cfg.dim))
            self.normal_params = ("pos_embedding", "exploration_token",
                                  "exploitation_token")
        else:
            self.cls_token = nn.Parameter(torch.empty(1, 1, cfg.dim))
            self.normal_params = ("pos_embedding", "cls_token")
        self.transformer = Transformer(
            cfg.dim, cfg.depth, cfg.heads, cfg.dim_head, cfg.mlp_dim, cfg.dropout,
            attention_route, ffn_route, 2 if self.fused else 0, dtype, remat)
        self.emb_drop = Dropout16(cfg.emb_dropout)

    def forward(self, img: torch.Tensor,
                rng: Optional[Rng] = None) -> Tuple[torch.Tensor, ...]:
        """img: [B, C, H, W] float in [0, 1]. Returns ``(x_explore,
        x_exploit)`` with explorative attention, else ``(x_cls,)``."""
        x = patchify(img.to(self.dtype or torch.float32), self.cfg.patch_size)
        x = self.patch_norm_out(self.patch_proj(self.patch_norm_in(x)))
        b, n, dim = x.shape
        pos = self.pos_embedding.to(x.dtype)

        def with_token(token):
            seq = torch.cat([token.to(x.dtype).expand(b, 1, dim), x], dim=1)
            return seq + pos[:, : n + 1]

        if self.cfg.use_explorative_attn:
            if self.fused:
                toks = torch.cat([
                    self.exploration_token.to(x.dtype).expand(b, 1, dim),
                    self.exploitation_token.to(x.dtype).expand(b, 1, dim),
                ], dim=1) + pos[:, :1]
                seq = torch.cat([toks, x + pos[:, 1: n + 1]], dim=1)
                out = self.transformer(self.emb_drop(seq, rng), rng).float()
                return out[:, 0], out[:, 1]
            seq = torch.cat([with_token(self.exploration_token),
                             with_token(self.exploitation_token)], dim=0)
            out = self.transformer(self.emb_drop(seq, rng), rng)[:, 0].float()
            return out[:b], out[b:]
        seq = self.emb_drop(with_token(self.cls_token), rng)
        return (self.transformer(seq, rng)[:, 0].float(),)
