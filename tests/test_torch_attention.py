"""The port's attention forward, layers and mha against the JAX package.

The plain version of the Hopper kernel runs here (CPU tensors); the JAX side
is the head-packed Pallas forward in interpret mode, as the JAX package's own
tests run it.  Inputs come from numpy seeds; fp32 throughout, at the
tolerances of tests/test_flash_attention.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fsvlm_tpu.ops import attention as jax_attention
from fsvlm_tpu.ops import layers as jax_layers
from fsvlm_tpu.ops.flash_attention import _hp_fwd_impl, packed_attention
from fsvlm_tpu_torch.ops import attention, flash_attention, layers


def _unpack_lse(lse, B, H, L):
    """(B*H/2, Lq, 128) packed per-head LSE -> (B, H, L)."""
    lse = np.asarray(lse)
    Lq = lse.shape[1]
    return lse.reshape(B, H // 2, Lq, 2, 64)[..., 0].transpose(0, 1, 3, 2).reshape(B, H, Lq)[:, :, :L]


def _qkv(B, H, L, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, H, L, 64).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "nomask"])
@pytest.mark.parametrize("L", [1, 8, 16, 24, 77, 201, 513])
@pytest.mark.parametrize("H", [2, 4])
def test_attention_fwd_matches_packed_pallas(H, L, causal):
    B = 2
    q, k, v = _qkv(B, H, L, seed=L + H)
    mask_j = jax_attention.causal_mask(L) if causal else None
    o_ref, lse_ref = _hp_fwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  mask_j, 256, 512, True)
    mask_t = attention.causal_mask(L, device="cpu") if causal else None
    o, lse = flash_attention.attention_fwd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), mask_t)
    assert o.dtype == torch.float32 and lse.shape == (B, H, L)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), _unpack_lse(lse_ref, B, H, L),
                               rtol=2e-4, atol=2e-5)


def test_packed_attention_entry_matches_its_impl():
    q, k, v = [jnp.asarray(t) for t in _qkv(2, 2, 77, seed=3)]
    mask = jax_attention.causal_mask(77)
    out = packed_attention(q, k, v, mask, 256, 512, True)
    o, _ = flash_attention.attention_fwd(*[torch.from_numpy(np.array(t)) for t in (q, k, v)],
                                         attention.causal_mask(77, device="cpu"))
    np.testing.assert_allclose(o.numpy(), np.asarray(out), rtol=2e-4, atol=2e-5)


def test_attention_fwd_takes_strided_views_and_rejects_bad_impl():
    B, H, L = 2, 2, 24
    qkv = torch.from_numpy(np.random.RandomState(0).randn(B, L, 3 * H * 64).astype(np.float32))
    q, k, v = [t.view(B, L, H, 64).transpose(1, 2) for t in qkv.split(H * 64, dim=-1)]
    o, lse = flash_attention.attention_fwd(q, k, v)
    o2, lse2 = flash_attention.attention_fwd(q.contiguous(), k.contiguous(), v.contiguous())
    torch.testing.assert_close(o, o2, rtol=0, atol=0)
    torch.testing.assert_close(lse, lse2, rtol=0, atol=0)
    with pytest.raises(ValueError):
        flash_attention.attention_fwd(q, k, v, impl="kernel")


def test_layer_norm_quick_gelu_linear_match_jax():
    rng = np.random.RandomState(0)
    x = (3 * rng.randn(2, 7, 48) + 1).astype(np.float32)
    scale, bias = rng.randn(48).astype(np.float32), rng.randn(48).astype(np.float32)
    w, b = rng.randn(48, 80).astype(np.float32), rng.randn(80).astype(np.float32)
    t = torch.from_numpy
    np.testing.assert_allclose(layers.layer_norm(t(x), t(scale), t(bias)).numpy(),
                               np.asarray(jax_layers.layer_norm(x, scale, bias)), atol=1e-5)
    np.testing.assert_allclose(layers.quick_gelu(t(x)).numpy(),
                               np.asarray(jax_layers.quick_gelu(x)), atol=1e-5)
    np.testing.assert_allclose(layers.linear(t(x), t(w), t(b)).numpy(),
                               np.asarray(jax_layers.linear(x, w, b)), atol=1e-5, rtol=1e-5)


def test_layer_norm_keeps_bf16_and_fp32_statistics():
    x = torch.from_numpy(np.random.RandomState(1).randn(3, 64).astype(np.float32) * 50 + 300)
    y = layers.layer_norm(x.bfloat16(), torch.ones(64), torch.zeros(64))
    assert y.dtype == torch.bfloat16
    ref = layers.layer_norm(x.bfloat16().float(), torch.ones(64), torch.zeros(64))
    torch.testing.assert_close(y.float(), ref.bfloat16().float(), rtol=0, atol=0)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "nomask"])
def test_mha_matches_jax(causal):
    rng = np.random.RandomState(2)
    B, L, D, H = 3, 13, 128, 2
    x = rng.randn(B, L, D).astype(np.float32)
    w_qkv = (rng.randn(D, 3 * D) * D ** -0.5).astype(np.float32)
    b_qkv = (0.1 * rng.randn(3 * D)).astype(np.float32)
    w_out = (rng.randn(D, D) * D ** -0.5).astype(np.float32)
    b_out = (0.1 * rng.randn(D)).astype(np.float32)
    ref = jax_attention.mha(x, w_qkv, b_qkv, w_out, b_out, H,
                            mask=jax_attention.causal_mask(L) if causal else None)
    t = torch.from_numpy
    out = attention.mha(t(x), t(w_qkv), t(b_qkv), t(w_out), t(b_out), H,
                        mask=attention.causal_mask(L, device="cpu") if causal else None)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_causal_mask_matches_jax():
    np.testing.assert_array_equal(attention.causal_mask(9, device="cpu").numpy(),
                                  np.asarray(jax_attention.causal_mask(9)))


def test_kernel_is_a_torch_operator_with_a_fake_implementation():
    """The Hopper kernel is registered as ``torch.ops.fsvlm.flash_attn_fwd_d64``
    for CUDA only; its fake implementation gives the shapes, dtypes and the
    (B, L, H, d) memory layout of O that the kernel writes."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    op = torch.ops.fsvlm.flash_attn_fwd_d64
    with FakeTensorMode():
        q = torch.empty(2, 3, 10, 64, dtype=torch.bfloat16)
        o, lse = op(q, q, q, None)
    assert o.shape == (2, 3, 10, 64) and o.dtype == torch.bfloat16
    assert o.transpose(1, 2).is_contiguous()
    assert lse.shape == (2, 3, 10) and lse.dtype == torch.float32
    q = torch.zeros(1, 2, 4, 64)
    with pytest.raises(NotImplementedError):  # no CPU kernel: the wrapper takes the plain version
        op(q, q, q, None)
    before = flash_attention.LAUNCHES[flash_attention.KERNEL]
    flash_attention.attention_fwd(q, q, q)
    assert flash_attention.LAUNCHES[flash_attention.KERNEL] == before
