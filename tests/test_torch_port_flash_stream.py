"""K5f, K5q and K5kv of the torch port (eavit_tpu_torch/ops/flash_stream)
against the JAX package.

The forward of ``flash_attention_stream`` and its gradient through the port's
``autograd.Function`` (the plain versions on the CPU) are held to
``eavit_tpu.ops.flash_stream.flash_attention_stream`` and its JAX gradient
(``jax.vjp``, the custom VJP that ``jax.grad`` takes),
which run the Pallas ``_fwd_kernel``, ``_bwd_dq_kernel`` and
``_bwd_dkv_kernel`` in interpret mode on the CPU, on ragged sequence lengths
(11 and 13 inside one tile, 150 over two tiles of 128 that the test pins)
with and without the dual-query mask: float32 at 1e-5 of each output's
scale, bfloat16 at 2e-2 (the rounding of o, dq, dk and dv to bf16). The row
log-sum-exp is held to the one the Pallas forward returns (1e-5). The
explicit plain backward must equal torch autograd through the plain forward
(1e-5), and the plain forward K4's plain forward (the same function written
another way, 1e-6). The ``"stream"`` route of the ViT's attention drops the
attention output, not its probabilities: at rate 0.1 it must equal plain
attention followed by ``dropout16`` on ``[B, H, N, Dh]`` from the same
generator state. The numerics of the bf16 K5q and K5kv (p and ds as two
bf16 terms, products summed in f32) are emulated in torch and held to the
JAX gradient on keys that make dq nearly cancel (N = 198), and the bf16 K5f's
one-sweep online softmax (p as two bf16 terms, the accumulator rescaled as
the row maximum moves) is emulated over 16- and 64-key steps and held to the
JAX forward (o within one bf16 rounding, lse within 1e-4). The CUDA kernels
are held to the plain versions on a GPU by test_torch_port_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eavit_tpu.ops import flash_stream as jax_stream
from eavit_tpu_torch.models.layers import Rng
from eavit_tpu_torch.models.vit import MultiHeadAttention
from eavit_tpu_torch.ops import flash, flash_stream
from eavit_tpu_torch.ops.attention import dropout16, mha

# One intra-op thread: the suite runs several test processes on one host.
torch.set_num_threads(1)

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture
def jax_tiles_128():
    """Tiles of 128 on the JAX side, so that N = 150 streams two key tiles
    and two query tiles; the automatic size is restored afterwards (the
    test processes run several files one after another)."""
    jax_stream.set_blocks(128, 128)
    yield
    jax_stream.set_blocks(None, None)


def _inputs(seed, b, h, n, dh):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, n, dh)).astype(np.float32) for _ in range(4)]


def _assert_close(ours, ref, tol):
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(ours, ref, rtol=tol, atol=tol * scale)


# each N with both masks and both dtypes, each mask with both dtypes (every
# case traces three interpret-mode kernels, about 1.5 s)
@pytest.mark.parametrize("n,num_special,dtype", [
    (11, 0, "float32"), (11, 2, "bfloat16"), (13, 2, "float32"), (13, 0, "bfloat16"),
    (150, 2, "float32"), (150, 0, "bfloat16")])
def test_forward_and_gradient_match_jax(jax_tiles_128, n, num_special, dtype):
    b, h, dh = (2, 2, 8) if n < 128 else (1, 1, 8)
    q, k, v, g = _inputs(n + num_special, b, h, n, dh)
    jdt, tdt = JDT[dtype], TDT[dtype]
    tol = 1e-5 if dtype == "float32" else 2e-2
    jq, jk, jv, jg = (jnp.asarray(t, jdt) for t in (q, k, v, g))
    # the output and the gradients of <o, g> in one trace of the kernels
    ref_o, vjp = jax.vjp(lambda *t: jax_stream.flash_attention_stream(
        *t, num_special=num_special), jq, jk, jv)
    ref_grads = vjp(jg)

    ts = [torch.tensor(t).to(tdt).requires_grad_() for t in (q, k, v)]
    before = dict(flash_stream.launches)
    out = flash_stream.flash_attention_stream(*ts, num_special=num_special)
    assert out.dtype == tdt and out.shape == (b, h, n, dh)
    _assert_close(out.detach().float().numpy(), np.asarray(ref_o, np.float32), tol)
    out.backward(torch.tensor(g).to(tdt))
    for t, r in zip(ts, ref_grads):
        assert t.grad.dtype == tdt
        _assert_close(t.grad.float().numpy(), np.asarray(r, np.float32), tol)
    assert flash_stream.launches == before  # CPU tensors take the plain versions
    if dtype == "float32":
        fold = lambda t: t.reshape(b * h, n, dh)  # noqa: E731
        _, ref_lse = jax_stream._fwd(fold(jq), fold(jk), fold(jv), dh ** -0.5, num_special)
        _, lse = flash_stream.flash_stream_fwd_plain(*(t.detach() for t in ts),
                                                     dh ** -0.5, num_special)
        _assert_close(lse.reshape(b * h, n).numpy(), np.asarray(ref_lse), 1e-5)


@pytest.mark.parametrize("num_special", [0, 2])
def test_plain_backward_is_autograd_of_the_plain_forward(num_special):
    b, h, n, dh = 2, 2, 13, 8
    q, k, v, g = _inputs(5, b, h, n, dh)
    scale = 0.3
    leaves = [torch.tensor(t, requires_grad=True) for t in (q, k, v)]
    o, lse = flash_stream.flash_stream_fwd_plain(*leaves, scale, num_special)
    do = torch.tensor(g)
    ref = torch.autograd.grad(o, leaves, do)
    delta = flash_stream.stream_delta(o.detach(), do)
    ours = flash_stream.flash_stream_bwd(*(t.detach() for t in leaves), lse.detach(),
                                         delta, do, scale, num_special)
    for a, r in zip(ours, ref):
        _assert_close(a.numpy(), r.numpy(), 1e-5)


@pytest.mark.parametrize("num_special", [0, 2])
def test_plain_forward_is_k4s_function(num_special):
    q, k, v, _ = (torch.tensor(t) for t in _inputs(7, 2, 3, 19, 16))
    o5, lse5 = flash_stream.flash_stream_fwd_plain(q, k, v, 0.25, num_special)
    o4, lse4 = flash.flash_fwd_plain(q, k, v, 0.25, num_special)
    _assert_close(o5.numpy(), o4.numpy(), 1e-6)
    _assert_close(lse5.numpy(), lse4.numpy(), 1e-6)


def test_mha_runs_k5_and_refuses_probability_dropout():
    q, k, v, _ = (torch.tensor(t) for t in _inputs(8, 2, 2, 11, 8))
    assert torch.equal(mha(q, k, v, impl="pallas_stream", num_special=2),
                       flash_stream.flash_attention_stream(q, k, v, num_special=2))
    with pytest.raises(ValueError, match="pallas_stream"):
        mha(q, k, v, impl="pallas_stream", dropout_rate=0.1)


@pytest.mark.parametrize("num_special", [0, 2])
def test_stream_route_drops_the_attention_output(num_special):
    dim, heads, dh, n, rate = 24, 3, 8, 12, 0.1
    attn = MultiHeadAttention(dim, heads, dh, rate, "stream", num_special, None)
    x = torch.tensor(np.random.default_rng(9).standard_normal((2, n, dim)),
                     dtype=torch.float32)
    with torch.no_grad():
        ours = attn(x, Rng(4, "cpu"))
        gen = Rng(4, "cpu").device  # the same generator state
        qkv = attn.to_qkv(attn.norm(x)).reshape(2, n, 3, heads, dh).permute(2, 0, 3, 1, 4)
        out = dropout16(mha(*qkv, num_special=num_special), rate, gen)
        ref = dropout16(attn.to_out(out.transpose(1, 2).reshape(2, n, heads * dh)),
                        rate, gen)
        assert not torch.equal(ours, attn(x))  # dropout is live with an Rng
    _assert_close(ours.numpy(), ref.numpy(), 1e-5)


def _two_terms(x):
    """An f32 operand as the tensor-core K5q and K5kv feed it to a bf16 mma:
    ``hi = bf16(x)`` and ``lo = bf16(x - hi)``, widened back to f32."""
    hi = x.to(torch.bfloat16)
    return hi.float(), (x - hi.float()).to(torch.bfloat16).float()


def _two_term_product(a, b):
    """``a @ b`` with f32 ``a`` split into two bf16 terms and bf16 ``b``, each
    product summed in f32, as the template sums them."""
    hi, lo = _two_terms(a)
    return torch.matmul(hi, b.float()) + torch.matmul(lo, b.float())


def test_bf16_backward_numerics_keep_a_cancelling_dq(jax_tiles_128):
    """The numerics of the bf16 K5q and K5kv, emulated in torch: p and ds f32
    as two bf16 terms, products summed in f32, outputs rounded to bf16. On
    keys ``8 + 0.01 noise`` (each row of ds sums to about 0, so ``dq = ds k``
    nearly cancels) at N = 198 they must match the JAX package's gradient
    (Pallas kernels in interpret mode, tiles of 128) within one bf16 ulp of
    each output's largest element (2^-7 of it): both round nearly equal f32
    sums to bf16. Rounding ds to bf16 before ``ds k`` errs at least 10x as
    much on dq."""
    b, h, n, dh, ns = 1, 2, 198, 32, 2
    scale = dh ** -0.5
    rng = np.random.default_rng(12)
    q, v, g, noise = (rng.standard_normal((b, h, n, dh)).astype(np.float32) for _ in range(4))
    jq, jk, jv, jg = (jnp.asarray(t, jnp.bfloat16) for t in (q, 8.0 + 0.01 * noise, v, g))
    ref_o, vjp = jax.vjp(lambda *t: jax_stream.flash_attention_stream(
        *t, num_special=ns), jq, jk, jv)
    ref = [torch.from_numpy(np.array(r, np.float32)) for r in vjp(jg)]
    fold = lambda t: t.reshape(b * h, n, dh)  # noqa: E731
    _, lse = jax_stream._fwd(fold(jq), fold(jk), fold(jv), scale, ns)

    # the same bf16 inputs, O and lse in torch; delta from the rounded O
    tq, tk, tv, tg, to = (torch.from_numpy(np.array(t, np.float32)).to(torch.bfloat16)
                          for t in (jq, jk, jv, jg, ref_o))
    tlse = torch.from_numpy(np.array(lse, np.float32)).reshape(b, h, n)
    p, ds = flash_stream._probs_and_ds(tq, tk, tv, tlse, flash_stream.stream_delta(to, tg),
                                       tg, scale, ns)
    dst = ds.transpose(-1, -2)
    ours = [_two_term_product(ds, tk), _two_term_product(dst, tq),
            _two_term_product(p.transpose(-1, -2), tg)]
    errs = []
    for mine, r in zip(ours, ref):
        err = (mine.to(torch.bfloat16).float() - r).abs().max().item()
        assert err <= 2.0 ** -7 * r.abs().max().item(), (err, r.abs().max().item())
        errs.append(err)
    rounded = torch.matmul(ds.to(torch.bfloat16).float(), tk.float()).to(torch.bfloat16)
    err_rounded = (rounded.float() - ref[0]).abs().max().item()
    assert err_rounded > 0 and err_rounded >= 10 * errs[0], (err_rounded, errs)


def _one_sweep_forward(q, k, v, scale, num_special, step):
    """The bf16 K5f of csrc/attn_fwd_mma.cuh (ONE_SWEEP) in torch: scores of
    the bf16 operands summed in f32, then per step of ``step`` keys the
    running row maximum m, the accumulator and the row sum rescaled by
    ``exp(m_old - m_new)``, the unnormalised ``p = exp(s - m)`` as two bf16
    terms against bf16 V, summed in f32; ``o = acc / l`` rounded to bf16 and
    ``lse = m + log l``."""
    from eavit_tpu_torch.ops.flash import masked_scores

    s = masked_scores(q, k, scale, num_special)  # f32, -inf where masked
    n = s.shape[-1]
    m = torch.full(s.shape[:-1], -float("inf"))
    l = torch.zeros(s.shape[:-1])
    acc = torch.zeros(*s.shape[:-1], v.shape[-1])
    vf = v.float()
    for j0 in range(0, n, step):
        blk = s[..., j0:j0 + step]
        mn = torch.maximum(m, blk.amax(dim=-1))
        off = torch.where(mn == -float("inf"), torch.zeros_like(mn), mn)
        alpha = torch.exp(m - off)
        p = torch.exp(blk - off[..., None])
        hi, lo = _two_terms(p)
        acc = acc * alpha[..., None] + (torch.matmul(hi, vf[..., j0:j0 + step, :])
                                        + torch.matmul(lo, vf[..., j0:j0 + step, :]))
        l = l * alpha + p.sum(dim=-1)
        m = mn
    return (acc / l[..., None]).to(torch.bfloat16), m + torch.log(l)


@pytest.mark.parametrize("num_special", [0, 2])
def test_bf16_one_sweep_forward_matches_jax(jax_tiles_128, num_special):
    """The numerics of the bf16 K5f, emulated (:func:`_one_sweep_forward`)
    over the kernel's 16-key steps and over 64-key tiles, against the JAX
    package's K5f (Pallas in interpret mode, tiles of 128) at bf16 ``[2, 2,
    198, 32]``: o within one bf16 rounding of each element (both round nearly
    equal f32 values; plus 2^-16 of o's largest element, the two terms' error
    in the f32 sum, which shows only where the sum nearly cancels), lse within
    1e-4."""
    b, h, n, dh = 2, 2, 198, 32
    scale = dh ** -0.5
    q, k, v, _ = _inputs(21 + num_special, b, h, n, dh)
    jq, jk, jv = (jnp.asarray(t, jnp.bfloat16) for t in (q, k, v))
    fold = lambda t: t.reshape(b * h, n, dh)  # noqa: E731
    ref_o, ref_lse = jax_stream._fwd(fold(jq), fold(jk), fold(jv), scale, num_special)
    ref_o = torch.from_numpy(np.array(ref_o.astype(jnp.float32))).reshape(b, h, n, dh)
    ref_lse = torch.from_numpy(np.array(ref_lse, np.float32)).reshape(b, h, n)
    tq, tk, tv = (torch.from_numpy(np.array(t.astype(jnp.float32))).to(torch.bfloat16)
                  for t in (jq, jk, jv))
    # one bf16 ulp of each element of the reference (2^-7 of its binade)
    ulp = torch.exp2(torch.floor(torch.log2(ref_o.abs().clamp_min(2.0 ** -100))) - 7)
    tol = ulp + 2.0 ** -16 * ref_o.abs().max()
    for step in (16, 64):
        o, lse = _one_sweep_forward(tq, tk, tv, scale, num_special, step)
        assert ((o.float() - ref_o).abs() <= tol).all(), step
        assert (lse - ref_lse).abs().max().item() <= 1e-4, step
