"""The port's attention backward, layer gradients and mha gradients against
the JAX package.

The plain versions of the Hopper backward kernels run here (CPU tensors); the
JAX side is ``packed_attention``'s custom VJP, whose backward runs the
head-packed Pallas kernels ``_hp_bwd_dkv_kernel`` / ``_hp_bwd_dq_kernel`` in
interpret mode, as the JAX package's own tests run them.  Inputs and dO come
from numpy seeds; fp32, at the tolerance of tests/test_flash_attention.py's
packed-gradient test (rtol 2e-4, atol 2e-4); bf16, the same draws rounded to
bf16, within chip_smoke.py's bf16 backward limit (1e-2 of the largest
gradient: an output ulp is 2^-8 relative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fsvlm_tpu.ops import attention as jax_attention
from fsvlm_tpu.ops import layers as jax_layers
from fsvlm_tpu.ops.flash_attention import DEFAULT_BLOCK_K, DEFAULT_BLOCK_Q, packed_attention
from fsvlm_tpu_torch.ops import attention, flash_attention, layers


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread: beside the suite's other workers a thread pool per
    op oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(B, H, L, d, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, H, L, d).astype(np.float32) for _ in range(4)]  # q, k, v, dO


def _port_grads(q, k, v, do, mask, impl=None):
    qkv = [t.requires_grad_() for t in (q, k, v)]
    o, _ = flash_attention.attention_fwd(*qkv, mask, impl=impl)
    return o, torch.autograd.grad(o, qkv, do)


def _check_against_packed(B, H, L, causal, bq, bk, seed, dtype=torch.float32):
    """fp32: O and each gradient within the packed-gradient test's rtol and
    atol.  bf16 (the same draws rounded): each gradient's max abs error
    within 1e-2 of JAX's largest gradient, and the port's in bf16."""
    q, k, v, do = [torch.from_numpy(t).to(dtype) for t in _inputs(B, H, L, 64, seed)]
    mask_j = jax_attention.causal_mask(L) if causal else None

    @jax.jit  # one XLA program: a third of the eager interpret-mode time
    def fwd_bwd(q_, k_, v_, do_):
        out, vjp = jax.vjp(lambda a, b, c: packed_attention(a, b, c, mask_j, bq, bk, True),
                           q_, k_, v_)
        return out, vjp(do_)

    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    out, ref = fwd_bwd(*[jnp.asarray(t.float().numpy(), jdt) for t in (q, k, v, do)])
    mask_t = attention.causal_mask(L, device="cpu") if causal else None
    o, grads = _port_grads(q, k, v, do, mask_t)
    if dtype == torch.float32:
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(out), rtol=2e-4, atol=2e-5)
        for name, got, want in zip(("dq", "dk", "dv"), grads, ref):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4,
                                       err_msg=name)
        return
    want = [np.asarray(r.astype(jnp.float32)) for r in ref]
    scale = max(np.abs(w).max() for w in want)
    for name, got, w in zip(("dq", "dk", "dv"), grads, want):
        assert got.dtype == dtype, name
        err = np.abs(got.float().numpy() - w).max() / scale
        assert err <= 1e-2, (name, err)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "nomask"])
@pytest.mark.parametrize("L", [1, 8, 16, 24, 77, 201, 300])
@pytest.mark.parametrize("H", [2, 4])
def test_attention_grads_match_packed_pallas_backward(H, L, causal):
    _check_against_packed(2, H, L, causal, DEFAULT_BLOCK_Q, DEFAULT_BLOCK_K, seed=L + H)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "nomask"])
@pytest.mark.parametrize("L", [8, 16, 24, 77, 201])
def test_attention_grads_match_packed_pallas_backward_bf16(L, causal):
    """bf16 inputs and dO through the plain forward and backward, the
    versions that the card holds kernels #6-#8 to, against JAX's packed
    forward and Pallas backward in bf16."""
    _check_against_packed(2, 2, L, causal, DEFAULT_BLOCK_Q, DEFAULT_BLOCK_K, seed=L + 40,
                          dtype=torch.bfloat16)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "nomask"])
def test_attention_grads_match_packed_pallas_backward_multi_block(causal):
    """L = 300 in JAX blocks of 128: three query and three key blocks."""
    _check_against_packed(1, 2, 300, causal, 128, 128, seed=11)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "nomask"])
def test_plain_attention_gradcheck_float64(causal):
    """The plain backward is the derivative of the plain forward: float64,
    L = 70 (two tiles of 64 each way), head dim 8."""
    rng = np.random.RandomState(5)
    q, k, v = [torch.from_numpy(rng.randn(1, 2, 70, 8)).requires_grad_() for _ in range(3)]
    mask = attention.causal_mask(70, dtype=torch.float64, device="cpu") if causal else None
    assert torch.autograd.gradcheck(
        lambda q_, k_, v_: flash_attention.attention_fwd(q_, k_, v_, mask)[0], (q, k, v),
        fast_mode=True)


def test_plain_backward_walks_the_kernel_tiles_like_plain_autograd():
    """reference_attention_bwd against autograd through a one-shot softmax
    attention (independent of the tiling), with a fully masked row."""
    q, k, v, do = [torch.from_numpy(t) for t in _inputs(2, 2, 130, 64, seed=3)]
    mask = torch.from_numpy(np.random.RandomState(4).randn(130, 130).astype(np.float32))
    mask[7] = float("-inf")
    o, lse = flash_attention.reference_attention_fwd(q, k, v, mask)
    dq, dk, dv = flash_attention.reference_attention_bwd(q, k, v, o, lse, do, mask)
    qkv = [t.clone().requires_grad_() for t in (q, k, v)]
    s = qkv[0] @ qkv[1].transpose(-1, -2) / 8.0 + mask
    p = torch.softmax(s.masked_fill(torch.isinf(mask), -1e30), dim=-1).masked_fill(
        torch.isinf(mask), 0.0)
    ref = torch.autograd.grad(p @ qkv[2], qkv, do)
    for got, want in zip((dq, dk, dv), ref):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    assert dq[:, :, 7].abs().max().item() == 0.0


def test_backward_operator_fake_implementation_and_cpu_path():
    """``torch.ops.fsvlm.flash_attn_bwd_d64`` is a CUDA-only operator with a
    fake implementation: dQ, dK, dV in q's shape and dtype, laid out
    (B, L, H, d).  CPU tensors take the plain versions and count no launch."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    op = torch.ops.fsvlm.flash_attn_bwd_d64
    with FakeTensorMode():
        q = torch.empty(2, 3, 10, 64, dtype=torch.bfloat16)
        lse = torch.empty(2, 3, 10, dtype=torch.float32)
        grads = op(q, q, q, q, lse, lse, None)
    for g in grads:
        assert g.shape == (2, 3, 10, 64) and g.dtype == torch.bfloat16
        assert g.transpose(1, 2).is_contiguous()
    q = torch.zeros(1, 2, 4, 64)
    lse = torch.zeros(1, 2, 4)
    with pytest.raises(NotImplementedError):  # no CPU kernel
        op(q, q, q, q, lse, lse, None)
    fa = flash_attention
    before = (fa.LAUNCHES[fa.KERNEL], fa.LAUNCHES[fa.KERNEL_DKV], fa.LAUNCHES[fa.KERNEL_DQ])
    qg = q.clone().requires_grad_()
    fa.attention_fwd(qg, q, q)[0].sum().backward()
    assert qg.grad is not None
    assert (fa.LAUNCHES[fa.KERNEL], fa.LAUNCHES[fa.KERNEL_DKV], fa.LAUNCHES[fa.KERNEL_DQ]) == before


def test_lse_output_takes_no_gradient():
    q, k, v, _ = [torch.from_numpy(t).requires_grad_() for t in _inputs(1, 2, 9, 64, seed=2)]
    o, lse = flash_attention.attention_fwd(q, k, v)
    assert o.requires_grad and not lse.requires_grad


# ------------------------------------------------------------------ layers
def _ln_inputs(dtype=np.float32):
    rng = np.random.RandomState(0)
    x = (3 * rng.randn(4, 7, 48) + 1).astype(dtype)
    scale, bias = rng.randn(48).astype(np.float32), rng.randn(48).astype(np.float32)
    g = rng.randn(4, 7, 48).astype(np.float32)
    return x, scale, bias, g


def test_layer_norm_grads_match_jax_custom_vjp():
    x, scale, bias, g = _ln_inputs()
    ref = jax.grad(lambda x_, s_, b_: (jax_layers.layer_norm(x_, s_, b_) * g).sum(),
                   argnums=(0, 1, 2))(x, scale, bias)
    ins = [torch.from_numpy(t).requires_grad_() for t in (x, scale, bias)]
    got = torch.autograd.grad((layers.layer_norm(*ins) * torch.from_numpy(g)).sum(), ins)
    for name, a, b in zip(("dx", "dscale", "dbias"), got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-5, err_msg=name)


def test_layer_norm_saves_x_in_its_own_dtype_and_fp32_statistics():
    x, scale, bias, g = _ln_inputs()
    xb = torch.from_numpy(x).bfloat16().requires_grad_()
    y = layers.layer_norm(xb, torch.from_numpy(scale), torch.from_numpy(bias))
    saved_x, _, mean, rstd = y.grad_fn.saved_tensors
    assert saved_x.dtype == torch.bfloat16 and saved_x.data_ptr() == xb.data_ptr()
    assert mean.dtype == rstd.dtype == torch.float32 and mean.shape == (4, 7, 1)
    dx, = torch.autograd.grad(y, xb, torch.from_numpy(g).bfloat16())
    ref = jax.grad(lambda x_: (jax_layers.layer_norm(x_, scale, bias).astype(jnp.float32)
                               * jnp.asarray(g, jnp.bfloat16).astype(jnp.float32)).sum())(
        jnp.asarray(x, jnp.bfloat16))
    assert dx.dtype == torch.bfloat16
    np.testing.assert_allclose(dx.float().numpy(), np.asarray(ref, np.float32), rtol=2e-2, atol=2e-2)


def test_quick_gelu_grads_match_jax_and_save_only_x():
    rng = np.random.RandomState(1)
    x = (3 * rng.randn(64)).astype(np.float32)
    g = rng.randn(64).astype(np.float32)
    ref = jax.grad(lambda x_: (jax_layers.quick_gelu(x_) * g).sum())(x)
    xt = torch.from_numpy(x).requires_grad_()
    y = layers.quick_gelu(xt)
    assert len(y.grad_fn.saved_tensors) == 1
    dx, = torch.autograd.grad((y * torch.from_numpy(g)).sum(), xt)
    np.testing.assert_allclose(dx.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("impl", [None, "plain"], ids=["default", "plain"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "nomask"])
def test_mha_grads_match_jax(causal, impl):
    """d(mha)/dx against jax.grad of the JAX mha (the towers are frozen, so
    x is the only gradient the train step needs)."""
    rng = np.random.RandomState(2)
    B, L, D, H = 3, 13, 128, 2
    x = rng.randn(B, L, D).astype(np.float32)
    w_qkv = (rng.randn(D, 3 * D) * D ** -0.5).astype(np.float32)
    b_qkv = (0.1 * rng.randn(3 * D)).astype(np.float32)
    w_out = (rng.randn(D, D) * D ** -0.5).astype(np.float32)
    b_out = (0.1 * rng.randn(D)).astype(np.float32)
    g = rng.randn(B, L, D).astype(np.float32)
    mask_j = jax_attention.causal_mask(L) if causal else None
    ref = jax.grad(lambda x_: (jax_attention.mha(x_, w_qkv, b_qkv, w_out, b_out, H, mask=mask_j)
                               * g).sum())(x)
    t = torch.from_numpy
    xt = t(x).requires_grad_()
    out = attention.mha(xt, t(w_qkv), t(b_qkv), t(w_out), t(b_out), H,
                        mask=attention.causal_mask(L, device="cpu") if causal else None, impl=impl)
    dx, = torch.autograd.grad(out, xt, t(g))
    np.testing.assert_allclose(dx.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)
