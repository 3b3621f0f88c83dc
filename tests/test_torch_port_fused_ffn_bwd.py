"""K2b of the torch port (the backward of eavit_tpu_torch/ops/fused_ffn)
against the JAX package.

At rate 0 all seven gradients of ``fused_ffn`` through the port's
``autograd.Function`` (the plain backward on the CPU) are held to ``jax.grad``
of ``eavit_tpu.ops.fused_ffn.fused_ffn``, which runs the Pallas
``_bwd_kernel`` in interpret mode on the CPU, on row counts that fill no
block (37 and 130), at float32 (1e-5 of each gradient's scale) and bfloat16
input (2e-2: the roundings of u, gd, dy0, dh and dx to bf16), and at widths
the fused CUDA kernels do not take, (40, 100) to (1,280, 5,120) and the HF
flavour's (1,024, 3,072) (also in bf16), with the forward too. The split
path's scratch plan holds no float32 hidden activation. The JAX weights
are ``[in, out]``, the port's ``[out, in]``. At rate 0.1 the explicit plain
backward must equal torch autograd through the plain forward, which proves
that it replays both masks (float32, 1e-5). The numerics of the CUDA kernel's
float32 path (every product on bf16 tensor cores, each operand as hi + lo
bf16 terms, three products summed in f32) are emulated in torch and held to
``jax.grad`` at rate 0 and to the plain backward at rate 0.1 (1e-4 of each
gradient's scale); one bf16 term per operand must err at least 10x as much on
some gradient. The CUDA kernel is held to the plain backward on a GPU by
test_torch_port_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eavit_tpu.ops import fused_ffn as jax_ff
from eavit_tpu_torch.ops import fused_ffn as ff
from eavit_tpu_torch.ops.kernel_prng import dropout_args, keep_mask

# One intra-op thread: the suite runs several test processes on one host.
torch.set_num_threads(1)

NAMES = ("x", "ln_w", "ln_b", "w1", "b1", "w2", "b2")


def _inputs(seed, rows, dim, hidden):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return dict(x=f(rows, dim), ln_w=1.0 + 0.1 * f(dim), ln_b=0.1 * f(dim),
                w1=f(hidden, dim) / float(np.sqrt(dim)), b1=0.1 * f(hidden),
                w2=f(dim, hidden) / float(np.sqrt(hidden)), b2=0.1 * f(dim)), f(rows, dim)


def _assert_close(ours, ref, tol, name):
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(ours, ref, rtol=tol, atol=tol * scale, err_msg=name)


def _jax_grads(p, g, jdt):
    """``jax.grad`` of ``<fused_ffn(x, ...), g>`` at rate 0 (the Pallas kernel
    in interpret mode), the weight gradients in the port's ``[out, in]``."""
    def jloss(x, ln_w, ln_b, w1, b1, w2, b2):
        y = jax_ff.fused_ffn(x, ln_w, ln_b, w1, b1, w2, b2)
        return jnp.sum(y.astype(jnp.float32) * jnp.asarray(g, jdt).astype(jnp.float32))

    jargs = [jnp.asarray(p["x"], jdt), jnp.asarray(p["ln_w"]), jnp.asarray(p["ln_b"]),
             jnp.asarray(p["w1"].T), jnp.asarray(p["b1"]), jnp.asarray(p["w2"].T),
             jnp.asarray(p["b2"])]
    ref = dict(zip(NAMES, jax.grad(jloss, argnums=tuple(range(7)))(*jargs)))
    ref["w1"], ref["w2"] = ref["w1"].T, ref["w2"].T  # to [out, in]
    return ref


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows", [37, 130])
def test_backward_matches_jax_grad_through_the_kernel(rows, dtype):
    dim, hidden = 48, 96
    p, g = _inputs(rows, rows, dim, hidden)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    ref = _jax_grads(p, g, jdt)

    targs = [torch.tensor(p["x"]).to(tdt).requires_grad_()] + [
        torch.tensor(p[k]).requires_grad_() for k in NAMES[1:]]
    ff.fused_ffn(*targs).backward(torch.tensor(g).to(tdt))
    assert targs[0].grad.dtype == tdt
    tol = 1e-5 if dtype == "float32" else 2e-2
    for name, t in zip(NAMES, targs):
        assert t.grad.shape == t.shape
        if name != "x":
            assert t.grad.dtype == torch.float32
        _assert_close(t.grad.float().numpy(), np.asarray(ref[name], np.float32), tol, name)


@pytest.mark.parametrize("dim,hidden", [(40, 100), (384, 1536), (1280, 5120), (1031, 100),
                                        (1024, 3072)])
def test_plain_forward_and_backward_match_jax_at_other_widths(dim, hidden):
    """The widths the fused kernels do not take (ragged, wider than 256, past
    1,024, and the HF flavour's (1,024, 3,072)),
    which the JAX kernel takes as one block: the plain forward and all seven
    gradients through the port's Function held to the Pallas kernel and
    ``jax.grad`` of it at float32 (1e-5 of each output's scale)."""
    rows = 11
    p, g = _inputs(dim + hidden, rows, dim, hidden)
    ref = _jax_grads(p, g, jnp.float32)
    jy = jax_ff.fused_ffn(jnp.asarray(p["x"]), jnp.asarray(p["ln_w"]), jnp.asarray(p["ln_b"]),
                          jnp.asarray(p["w1"].T), jnp.asarray(p["b1"]),
                          jnp.asarray(p["w2"].T), jnp.asarray(p["b2"]))
    targs = [torch.tensor(p[k]).requires_grad_() for k in NAMES]
    y = ff.fused_ffn(*targs)
    _assert_close(y.detach().numpy(), np.asarray(jy, np.float32), 1e-5, "y")
    y.backward(torch.tensor(g))
    for name, t in zip(NAMES, targs):
        assert t.grad.shape == t.shape
        _assert_close(t.grad.numpy(), np.asarray(ref[name], np.float32), 1e-5, name)


def test_plain_forward_and_backward_match_jax_at_the_hg_widths_in_bf16():
    """The HF flavour's widths (1,024, 3,072) with bf16 input, as its path
    runs K2: the plain forward and all seven gradients through the port's
    Function held to the Pallas kernel and ``jax.grad`` of it (2e-2 of each
    output's scale: the roundings of u, gd, dy0, dh and dx to bf16)."""
    rows, dim, hidden = 11, 1024, 3072
    p, g = _inputs(dim + hidden + 1, rows, dim, hidden)
    ref = _jax_grads(p, g, jnp.bfloat16)
    jy = jax_ff.fused_ffn(jnp.asarray(p["x"], jnp.bfloat16), jnp.asarray(p["ln_w"]),
                          jnp.asarray(p["ln_b"]), jnp.asarray(p["w1"].T), jnp.asarray(p["b1"]),
                          jnp.asarray(p["w2"].T), jnp.asarray(p["b2"]))
    targs = [torch.tensor(p["x"]).to(torch.bfloat16).requires_grad_()] + [
        torch.tensor(p[k]).requires_grad_() for k in NAMES[1:]]
    y = ff.fused_ffn(*targs)
    assert y.dtype == torch.bfloat16
    _assert_close(y.detach().float().numpy(), np.asarray(jy, np.float32), 2e-2, "y")
    y.backward(torch.tensor(g).to(torch.bfloat16))
    for name, t in zip(NAMES, targs):
        assert t.grad.shape == t.shape
        _assert_close(t.grad.float().numpy(), np.asarray(ref[name], np.float32), 2e-2, name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,dim,hidden", [(13056, 1024, 3072), (3264, 1024, 3072),
                                             (37, 40, 100), (37, 1031, 100)])
def test_split_path_keeps_the_hidden_activations_out_of_float32_scratch(rows, dim, hidden,
                                                                         dtype):
    """The scratch the split path's wrappers allocate (``split_scratch``, a
    pure function of the shape and dtype): the forward holds no float32
    buffer at all (no H, no Y), the backward none of a row by hidden unit (no
    H, no G) and only the float32 du, the row statistics, the partial column
    sums and the gradients; gd and dh are bf16 planes, two per value in
    float32 (hi + lo), one in bf16."""
    dp, hp = -(-dim // 32) * 32, -(-hidden // 32) * 32
    planes = 2 if dtype == torch.float32 else 1
    tiles = -(-rows // 64)
    fwd = {name: (shape, dt) for name, shape, dt in ff.split_scratch(rows, dim, hidden, dtype,
                                                                    True)}
    assert all(dt == torch.bfloat16 for _, dt in fwd.values())
    assert fwd["gd"] == ((planes, rows, hp), torch.bfloat16)
    bwd = {name: (shape, dt) for name, shape, dt in ff.split_scratch(rows, dim, hidden, dtype,
                                                                    False)}
    assert {name: shape for name, (shape, dt) in bwd.items() if dt == torch.float32} == {
        "grads": (2 * hp * dp + hp + 3 * dp,), "part_dx": (tiles, hp + 3 * dp),
        "du": (rows, dp), "stats": (2, rows)}
    assert bwd["hidden"] == ((2, planes, rows, hp), torch.bfloat16)  # dh, gd
    assert bwd["rows"] == ((2, planes, rows, dp), torch.bfloat16)  # u, dy0
    assert bwd["wplanes"] == ((3, planes, hp * dp), torch.bfloat16)  # W1, W2^T, W1^T


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("rows", [37, 130])
def test_plain_backward_is_autograd_of_the_plain_forward(rows, rate):
    dim, hidden, seeds = 48, 96, (5, 6)
    p, g = _inputs(rows + 1, rows, dim, hidden)
    args = [torch.tensor(p[k], requires_grad=True) for k in NAMES]
    y = ff.fused_ffn_fwd_plain(*args, seeds=seeds, rate=rate)
    ref = torch.autograd.grad(y, args, torch.tensor(g))
    with torch.no_grad():
        ours = ff.fused_ffn_bwd_plain(*args[:6], torch.tensor(g), seeds, rate)
    # the explicit order: dx, dln_w, dln_b, dw1, db1, dw2, db2
    for name, a, b in zip(NAMES, ours, ref):
        _assert_close(a.numpy(), b.numpy(), 1e-5, name)
    if rate:
        other = ff.fused_ffn_bwd_plain(*(a.detach() for a in args[:6]), torch.tensor(g),
                                       (1, 2), rate)
        assert not torch.allclose(other[0], ours[0], atol=1e-3)


def test_function_backward_honours_needs_input_grad_and_counts_no_launch():
    p, g = _inputs(3, 37, 48, 96)
    before = dict(ff.launches)
    args = [torch.tensor(p[k]) for k in NAMES]
    args[0].requires_grad_()
    args[3].requires_grad_()  # x and w1 only
    y = ff.fused_ffn(args[0].reshape(1, 37, 48), *args[1:], seeds=(8, 9), rate=0.1)
    assert y.shape == (1, 37, 48)
    y.backward(torch.tensor(g).reshape(1, 37, 48))
    assert args[0].grad is not None and args[3].grad is not None
    assert all(a.grad is None for i, a in enumerate(args) if i not in (0, 3))
    assert ff.launches == before  # CPU tensors take the plain versions
    with pytest.raises(ValueError):
        ff.fused_ffn(args[0], *args[1:], rate=0.1)  # rate > 0 needs seeds


def _terms(a, split):
    """An f32 operand as the K2b kernel feeds it to a bf16 mma: ``(hi, lo)``,
    ``hi = bf16(a)`` and ``lo = bf16(a - hi)`` widened back to f32, or
    ``(bf16(a),)`` alone."""
    hi = a.to(torch.bfloat16).float()
    return (hi, (a - hi).to(torch.bfloat16).float()) if split else (hi,)


def _product(a, b, split):
    """``a @ b`` as the kernel takes it: hi hi + hi lo + lo hi, each summed in
    f32 (``split``), or one product of the bf16 roundings."""
    ta, tb = _terms(a, split), _terms(b, split)
    out = torch.matmul(ta[0], tb[0])
    if split:
        out = out + torch.matmul(ta[0], tb[1]) + torch.matmul(ta[1], tb[0])
    return out


def _emulated_backward(x, ln_w, ln_b, w1, b1, w2, dy, seeds, rate, split, eps=1e-5):
    """The float32 K2b kernel's arithmetic in torch: the five products (fc1,
    dgd, dW2, dW1, du) through :func:`_product`, everything else in f32 as
    the plain backward takes it."""
    thresh, inv_keep, seeds = dropout_args(seeds, rate)
    mu = x.mean(dim=-1, keepdim=True)
    xc = x - mu
    rstd = torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + eps)
    xhat = xc * rstd
    u = xhat * ln_w + ln_b
    h = _product(u, w1.t(), split) + b1
    g = ff.gelu_exact(h)
    dy0 = dy
    if thresh is not None:
        m1 = keep_mask(g.shape, seeds, 0, thresh)
        m2 = keep_mask(dy.shape, seeds, 1, thresh)
        g = torch.where(m1, g * inv_keep, torch.zeros_like(g))
        dy0 = torch.where(m2, dy * inv_keep, torch.zeros_like(dy))
    dg = _product(dy0, w2, split)
    if thresh is not None:
        dg = torch.where(m1, dg * inv_keep, torch.zeros_like(dg))
    dh = ff.gelu_grad(h) * dg
    dw2 = _product(dy0.t(), g, split)
    dw1 = _product(dh.t(), u, split)
    du = _product(dh, w1, split)
    t = du * ln_w
    dx = (t - t.mean(dim=-1, keepdim=True)
          - xhat * (t * xhat).mean(dim=-1, keepdim=True)) * rstd
    return (dx, (du * xhat).sum(dim=0), du.sum(dim=0), dw1, dh.sum(dim=0), dw2,
            dy0.sum(dim=0))


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_three_term_products_keep_float32_gradients(rate):
    """The float32 K2b on the tensor cores, emulated: each operand of the
    five products as hi + lo bf16 terms, three products summed in f32. Every
    gradient within 1e-4 of its scale of ``jax.grad`` of the JAX package's
    fused FFN (rate 0) or of the plain backward (rate 0.1, which is autograd
    of the plain forward); one bf16 term per operand errs at least 10x as
    much on some gradient, so one term would miss the bar."""
    rows, dim, hidden, seeds = 130, 64, 96, (11, 12)
    p, g = _inputs(rows + 7, rows, dim, hidden)
    args = [torch.tensor(p[k]) for k in NAMES[:6]] + [torch.tensor(g)]
    if rate:
        ref = ff.fused_ffn_bwd_plain(*args[:6], args[6], seeds, rate)
    else:
        jref = _jax_grads(p, g, jnp.float32)
        ref = [torch.from_numpy(np.array(jref[k], np.float32)) for k in NAMES[:6]]
        ref.append(torch.from_numpy(np.array(jref["b2"], np.float32)))
    errs = {}
    for split in (True, False):
        ours = _emulated_backward(*args, seeds, rate, split)
        errs[split] = [(a - r).abs().max().item() / max(1.0, r.abs().max().item())
                       for a, r in zip(ours, ref)]
    for name, err in zip(NAMES, errs[True]):
        assert err <= 1e-4, (name, err)
    assert max(one / max(three, 1e-12) for one, three in zip(errs[False], errs[True])) >= 10, \
        errs
