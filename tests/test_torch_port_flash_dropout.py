"""K3f, K3b and K3r of the torch port (eavit_tpu_torch/ops/flash_dropout)
against the JAX package and the dropout contract.

At rate 0 ``flash_attention_dropout`` delegates to ``ops/flash`` (K4) as the
JAX function does, and its forward and gradient equal JAX's at rate 0, which
runs the Pallas ``ops/flash.py`` kernels in interpret mode (float32, 1e-5).
At rate > 0 the JAX entry runs no kernel on the CPU (it falls back to XLA
with 16-bit host-PRNG masks) and the TPU's core PRNG has no GPU twin, so the
port is held to its own replayed mask and to the distribution: the plain
forward equals a numpy composition of softmax, the mask replayed by
``dropout_raw_bits`` and the product (1e-5); the explicit plain backward
equals torch autograd through the plain forward (1e-5); the keep fraction
is the 24-bit threshold's within 4 sigma, and the mean output over many
seeds is the dropout-free output within 5 standard errors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eavit_tpu.ops import flash_dropout as jax_fd
from eavit_tpu_torch.ops import flash, flash_dropout as fd
from eavit_tpu_torch.ops.kernel_prng import keep_threshold

# One intra-op thread: the suite runs several test processes on one host.
torch.set_num_threads(1)

RATE = 0.1


def _inputs(seed, b, h, n, dh):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, n, dh)).astype(np.float32) for _ in range(4)]


def _assert_close(ours, ref, tol):
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(ours, ref, rtol=tol, atol=tol * scale)


@pytest.mark.parametrize("num_special", [0, 2])
def test_rate_zero_matches_jax_and_runs_no_k3(num_special):
    q, k, v, g = _inputs(1, 2, 2, 11, 8)

    def jloss(q_, k_, v_):
        o = jax_fd.flash_attention_dropout(q_, k_, v_, jax.random.PRNGKey(0), 0.0,
                                           num_special=num_special)
        return jnp.sum(o * jnp.asarray(g)), o

    (_, ref_o), ref_grads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(t) for t in (q, k, v)))
    before = dict(fd.launches)
    ts = [torch.tensor(t, requires_grad=True) for t in (q, k, v)]
    out = fd.flash_attention_dropout(*ts, seeds=(1, 2), rate=0.0, num_special=num_special)
    out.backward(torch.tensor(g))
    _assert_close(out.detach().numpy(), np.asarray(ref_o), 1e-5)
    for t, r in zip(ts, ref_grads):
        _assert_close(t.grad.numpy(), np.asarray(r), 1e-5)
    assert fd.launches == before
    # rate 0 is K4's function, bit for bit
    assert torch.equal(out, flash.flash_attention(*ts, num_special=num_special))
    with pytest.raises(ValueError, match="rate must be > 0"):
        fd.flash_dropout_fwd(*ts, (1, 2), 0.0, 0.3)


@pytest.mark.parametrize("num_special", [0, 2])
def test_plain_forward_is_softmax_under_the_replayed_mask(num_special):
    b, h, n, dh, seeds = 3, 2, 13, 8, (77, 5)
    q, k, v, _ = _inputs(2, b, h, n, dh)
    scale = dh ** -0.5
    o, lse = fd.flash_dropout_fwd(*(torch.tensor(t) for t in (q, k, v)), seeds, RATE,
                                  scale, num_special)

    s = np.einsum("bhid,bhjd->bhij", q.astype(np.float64), k) * scale
    if num_special:
        r, c = np.arange(n)[:, None], np.arange(n)[None, :]
        allowed = ((r >= num_special) & (c >= num_special)) | (
            (r < num_special) & ((c == r) | (c >= num_special)))
        s = np.where(allowed, s, -np.inf)
    m = s.max(-1, keepdims=True)
    e = np.exp(s - m)
    sigma = e / e.sum(-1, keepdims=True)
    thresh = keep_threshold(RATE)
    keep = fd.dropout_raw_bits(b, h, n, seeds, "cpu").numpy() < thresh
    ref = np.einsum("bhij,bhjd->bhid", np.where(keep, sigma * (1 << 24) / thresh, 0.0), v)
    _assert_close(o.numpy(), ref, 1e-5)
    _assert_close(lse.numpy(), (m + np.log(e.sum(-1, keepdims=True)))[..., 0], 1e-5)
    assert not keep.all() and keep.any()


# (num_special, (b, h, n, dh)): a short ragged sequence, and the flagship N =
# 198 at the flagship head width, which the bf16 CUDA kernel pads to 13 tiles
AUTOGRAD_CASES = [(0, (2, 2, 13, 8)), (2, (2, 2, 13, 8)), (2, (1, 2, 198, 32))]


@pytest.mark.parametrize("num_special,shape", AUTOGRAD_CASES,
                         ids=["0", "2", "2-198-32"])
def test_plain_backward_is_autograd_of_the_plain_forward(num_special, shape):
    (b, h, n, dh), seeds = shape, (17, 29)
    q, k, v, g = _inputs(3, b, h, n, dh)
    scale = dh ** -0.5
    leaves = [torch.tensor(t, requires_grad=True) for t in (q, k, v)]
    o, lse = fd.flash_dropout_fwd_plain(*leaves, seeds, RATE, scale, num_special)
    ref = torch.autograd.grad(o, leaves, torch.tensor(g))
    plain = [t.detach() for t in leaves]
    ours = fd.flash_dropout_bwd_plain(*plain, lse.detach(), torch.tensor(g), seeds, RATE,
                                      scale, num_special)
    for a, r in zip(ours, ref):
        _assert_close(a.numpy(), r.numpy(), 1e-5)
    # the Function's backward is the same replay, and counts no launch here
    before = dict(fd.launches)
    mine = [t.clone().requires_grad_() for t in plain]
    fd.flash_attention_dropout(*mine, seeds, RATE, num_special=num_special).backward(
        torch.tensor(g))
    for t, r in zip(mine, ref):
        _assert_close(t.grad.numpy(), r.numpy(), 1e-5)
    assert fd.launches == before
    # another seed is another mask: the backward depends on the replay
    other = fd.flash_dropout_bwd_plain(*plain, lse.detach(), torch.tensor(g), (1, 2),
                                       RATE, scale, num_special)
    assert not torch.allclose(other[0], ours[0], atol=1e-3)


def test_keep_fraction_and_unbiasedness():
    thresh = keep_threshold(RATE)
    p = thresh / (1 << 24)
    bits = fd.dropout_raw_bits(3, 2, 64, (11, 12), "cpu")
    assert bits.dtype == torch.int32 and bits.shape == (3, 2, 64, 64)
    keep = (bits < thresh).double().mean().item()
    assert abs(keep - p) < 4 * np.sqrt(p * (1 - p) / bits.numel())

    b, h, n, dh, draws = 1, 2, 11, 8, 400
    q, k, v, _ = (torch.tensor(t) for t in _inputs(4, b, h, n, dh))
    scale = dh ** -0.5
    outs = torch.stack([fd.flash_dropout_fwd_plain(q, k, v, (s, 3 * s + 1), RATE, scale)[0]
                        for s in range(draws)]).double()
    sigma = torch.softmax(flash.masked_scores(q, k, scale, 0).double(), dim=-1)
    ref = torch.matmul(sigma, v.double())
    # per element: Var = sum_j sigma_j^2 v_jd^2 (1 - p) / p for one draw
    var = torch.matmul(sigma ** 2, v.double() ** 2) * (1 - p) / p
    assert ((outs.mean(0) - ref).abs() <= 5 * (var / draws).sqrt()).all()
