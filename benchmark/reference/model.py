"""Plain float32 PyTorch reference of the PPO+RND agent's networks.

Written from the published description of the system (a dual-token ViT
whose exploration token feeds the intrinsic critic, its exploitation token
the extrinsic critic and their mean the actor; an RND predictor and target
over the last raw frame), with no kernel and nothing of the program under
test. Parameters are a flat dict ``name -> tensor`` under the names the
program's modules use, so one set of weights made from the seed serves both.

Both backbone flavours run in shared-patch-stream mode: one sequence
``[tok_explore, tok_exploit, patches]`` under the dual-query mask (patch
rows see patch columns only; special row ``i`` sees itself and the
patches), both tokens at position 0.

:class:`Precision` says how each product is computed. ``lower=False``: every
product in float32 with TF32 off. ``lower=True`` is the control: each
product one step below the precision the configuration states for it
(bfloat16-stated products on float8 e4m3 operands with a per-tensor scale,
float32-stated ones on bfloat16 operands), the sums in float32.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference.prng import dropout16_keep, kernel_keep, seed_words

Weights = Dict[str, torch.Tensor]
# (name, shape, kind, scale): kind "one" / "zero" (LayerNorm), "uniform"
# (U(-scale, scale), scale = 1/sqrt(fan_in)) or "normal" (N(0, scale^2))
LeafSpec = Tuple[str, Tuple[int, ...], str, float]

_E4M3_MAX = 448.0


def _round(x: torch.Tensor, stated: str) -> torch.Tensor:
    if stated == "f32":
        r = x.to(torch.bfloat16).float()
    else:
        s = x.detach().abs().amax().clamp_min(1e-30) / _E4M3_MAX
        r = (x.detach() / s).to(torch.float8_e4m3fn).float() * s
    return x + (r - x).detach()  # rounded forward, straight-through backward


class Precision:
    def __init__(self, lower: bool = False) -> None:
        self.lower = lower

    def op(self, x: torch.Tensor, stated: str) -> torch.Tensor:
        return _round(x, stated) if self.lower else x

    def dense(self, x, w, b, stated: str) -> torch.Tensor:
        y = torch.matmul(self.op(x, stated), self.op(w, stated).t())
        return y if b is None else y + b

    def matmul(self, a, b, stated: str) -> torch.Tensor:
        return torch.matmul(self.op(a, stated), self.op(b, stated))

    def conv(self, x, w, b, stride: int) -> torch.Tensor:
        return F.conv2d(self.op(x, "f32"), self.op(w, "f32"), b, stride=stride)


class Draws:
    """The dropout draws of one network forward, in the program's order."""

    def __init__(self, host: torch.Generator, dev: torch.Generator, device,
                 live: bool) -> None:
        self.host, self.dev, self.device, self.live = host, dev, device, live

    def drop16(self, shape, rate: float):
        if not self.live or rate <= 0.0:
            return None, 1.0
        return dropout16_keep(shape, rate, self.dev, self.device)

    def words(self, rate: float) -> Optional[Tuple[int, int]]:
        if not self.live or rate <= 0.0:
            return None
        return seed_words(self.host)


def _apply(x: torch.Tensor, keep) -> torch.Tensor:
    mask, scale = keep
    return x if mask is None else torch.where(mask, x * scale, torch.zeros_like(x))


def _ln(x, W, name, eps):
    return F.layer_norm(x, x.shape[-1:], W[name + ".weight"], W[name + ".bias"], eps)


def _dense(P, x, W, name, stated):
    return P.dense(x, W[name + ".weight"], W.get(name + ".bias"), stated)


def patchify(img: torch.Tensor, patch: int) -> torch.Tensor:
    """[B, C, H, W] -> [B, patches, p*p*C], rows, columns, then channels
    fastest within a patch."""
    b, c, h, w = img.shape
    gh, gw = h // patch, w // patch
    x = img.reshape(b, c, gh, patch, gw, patch).permute(0, 2, 4, 3, 5, 1)
    return x.reshape(b, gh * gw, patch * patch * c)


def dual_query_allowed(n: int, special: int, device) -> torch.Tensor:
    r = torch.arange(n, device=device)[:, None]
    c = torch.arange(n, device=device)[None, :]
    return ((r >= special) & (c >= special)) | ((r < special) & ((c == r) | (c >= special)))


def attention(P: Precision, qkv, heads: int, dim_head: int, words, rate: float):
    """Softmax attention of the raw qkv projection under the dual-query
    mask, with probability dropout from the kernel's Philox bits."""
    b, n, _ = qkv.shape
    inner = heads * dim_head
    q, k, v = (t.reshape(b, n, heads, dim_head).permute(0, 2, 1, 3)
               for t in qkv.split(inner, dim=-1))
    s = P.matmul(q, k.transpose(-1, -2), "bf16") * dim_head ** -0.5
    s = s.masked_fill(~dual_query_allowed(n, 2, qkv.device), float("-inf"))
    p = torch.softmax(s, dim=-1)
    if words is not None:
        p = _apply(p, kernel_keep((b, heads, n, n), words, 0, rate, qkv.device))
    o = P.matmul(p, v, "bf16")
    return o.permute(0, 2, 1, 3).reshape(b, n, inner)


def encoder(P, W, hp, prefix: str, x, draws: Draws):
    rate, eps = hp["dropout"], hp["norm_eps"]
    ffn = hp["ffn_stated"]
    for i in range(hp["depth"]):
        a = f"{prefix}.attn_{i}"
        qkv = _dense(P, _ln(x, W, a + ".norm", eps), W, a + ".to_qkv", "bf16")
        o = attention(P, qkv, hp["heads"], hp["dim_head"], draws.words(rate), rate)
        o = _dense(P, o, W, a + ".to_out", "bf16")
        x = x + _apply(o, draws.drop16(o.shape, rate))
        f = f"{prefix}.ff_{i}"
        words = draws.words(rate)
        h = _dense(P, _ln(x, W, f + ".norm", eps), W, f + ".fc1", ffn)
        g = F.gelu(h, approximate="none")
        rows = g.reshape(-1, g.shape[-1])
        if words is not None:
            rows = _apply(rows, kernel_keep(rows.shape, words, 0, rate, x.device))
        y = _dense(P, rows, W, f + ".fc2", ffn)
        if words is not None:
            y = _apply(y, kernel_keep(y.shape, words, 1, rate, x.device))
        x = x + y.reshape(x.shape)
    return _ln(x, W, prefix + ".norm", eps)


def backbone(P, W, hp, img, draws: Draws):
    """img [B, C, H, W] in [0, 1] -> (explore, exploit) token features."""
    f = "policy.feature"
    if hp["arch"] == "dual_token_vit":
        x = patchify(img, hp["patch"])
        x = _ln(x, W, f + ".patch_norm_in", 1e-6)
        x = _dense(P, x, W, f + ".patch_proj", "bf16")
        x = _ln(x, W, f + ".patch_norm_out", 1e-6)
        blocks = f + ".transformer"
    else:
        edge = (hp["image"] // hp["patch"]) * hp["patch"]
        x = _dense(P, patchify(img[:, :, :edge, :edge], hp["patch"]), W, f + ".patch_proj",
                   "bf16")
        blocks = f + ".encoder"
    b, n, dim = x.shape
    pos = W[f + ".pos_embedding"]
    toks = torch.cat([W[f + ".exploration_token"].expand(b, 1, dim),
                      W[f + ".exploitation_token"].expand(b, 1, dim)], dim=1) + pos[:, :1]
    seq = torch.cat([toks, x + pos[:, 1:n + 1]], dim=1)
    seq = _apply(seq, draws.drop16(seq.shape, hp["emb_dropout"]))
    out = encoder(P, W, hp, blocks, seq, draws)
    return out[:, 0], out[:, 1]


def policy(P, W, hp, obs_u8, draws: Draws):
    """Actor-critic forward: ``(logits [B, A], value_ext [B], value_int [B])``."""
    explore, exploit = backbone(P, W, hp, obs_u8.float() / 255.0, draws)

    def critic(name, x):
        h = torch.relu(_dense(P, x, W, "policy.extra_fc", "bf16")) + x
        return _dense(P, h, W, name, "bf16")[:, 0]

    comb = 0.5 * (explore + exploit)
    logits = _dense(P, torch.relu(_dense(P, comb, W, "policy.actor_fc1", "bf16")), W,
                    "policy.actor_fc2", "bf16")
    return logits, critic("policy.critic_ext", exploit), critic("policy.critic_int", explore)


def rnd_trunk(P, W, prefix, x):
    for i, stride in ((1, 4), (2, 2), (3, 1)):
        c = f"{prefix}.trunk.conv{i}"
        x = F.leaky_relu(P.conv(x, W[c + ".weight"], W[c + ".bias"], stride), 0.01)
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


def rnd_target(P, W, x):
    return _dense(P, rnd_trunk(P, W, "rnd_target", x), W, "rnd_target.head", "f32")


def rnd_predictor(P, W, x):
    h = torch.relu(_dense(P, rnd_trunk(P, W, "rnd_pred", x), W, "rnd_pred.head1", "f32"))
    h = torch.relu(_dense(P, h, W, "rnd_pred.head2", "f32"))
    return _dense(P, h, W, "rnd_pred.head3", "f32")


# ---------------------------------------------------------------------------
# the leaves and their init rule
# ---------------------------------------------------------------------------


def leaf_specs(hp) -> List[LeafSpec]:
    """Every parameter of the agent: name, shape, init kind and scale."""
    out: List[LeafSpec] = []

    def ln(name, n):
        out.extend([(name + ".weight", (n,), "one", 1.0), (name + ".bias", (n,), "zero", 0.0)])

    def dense(name, n_in, n_out, bias=True):
        s = 1.0 / math.sqrt(n_in)
        out.append((name + ".weight", (n_out, n_in), "uniform", s))
        if bias:
            out.append((name + ".bias", (n_out,), "uniform", s))

    def conv(name, c_in, c_out, k):
        s = 1.0 / math.sqrt(c_in * k * k)
        out.extend([(name + ".weight", (c_out, c_in, k, k), "uniform", s),
                    (name + ".bias", (c_out,), "uniform", s)])

    f, dim, p, c = "policy.feature", hp["dim"], hp["patch"], hp["channels"]
    grid = hp["image"] // p
    pd = c * p * p
    if hp["arch"] == "dual_token_vit":
        ln(f + ".patch_norm_in", pd)
        dense(f + ".patch_proj", pd, dim)
        ln(f + ".patch_norm_out", dim)
        blocks = f + ".transformer"
    else:
        dense(f + ".patch_proj", pd, dim)
        blocks = f + ".encoder"
    std = hp["embedding_std"]
    out.append((f + ".pos_embedding", (1, grid * grid + 1, dim), "normal", std))
    out.append((f + ".exploration_token", (1, 1, dim), "normal", std))
    out.append((f + ".exploitation_token", (1, 1, dim), "normal", std))
    inner = hp["heads"] * hp["dim_head"]
    for i in range(hp["depth"]):
        a = f"{blocks}.attn_{i}"
        ln(a + ".norm", dim)
        dense(a + ".to_qkv", dim, 3 * inner, bias=hp["qkv_bias"])
        dense(a + ".to_out", inner, dim)
        m = f"{blocks}.ff_{i}"
        ln(m + ".norm", dim)
        dense(m + ".fc1", dim, hp["mlp"])
        dense(m + ".fc2", hp["mlp"], dim)
    ln(blocks + ".norm", dim)
    dense("policy.actor_fc1", dim, dim)
    dense("policy.actor_fc2", dim, hp["actions"])
    dense("policy.extra_fc", dim, dim)
    dense("policy.critic_ext", dim, 1)
    dense("policy.critic_int", dim, 1)
    h, w = hp["frame"]
    for k, s in ((8, 4), (4, 2), (3, 1)):
        h, w = (h - k) // s + 1, (w - k) // s + 1
    flat = h * w * 64
    for net in ("rnd_pred", "rnd_target"):
        conv(net + ".trunk.conv1", 1, 32, 8)
        conv(net + ".trunk.conv2", 32, 64, 4)
        conv(net + ".trunk.conv3", 64, 64, 3)
    dense("rnd_pred.head1", flat, 512)
    dense("rnd_pred.head2", 512, 512)
    dense("rnd_pred.head3", 512, 512)
    dense("rnd_target.head", flat, 512)
    return out


def trainable(name: str) -> bool:
    """The leaves the optimizer steps: the policy's and the predictor's."""
    return not name.startswith("rnd_target.")
