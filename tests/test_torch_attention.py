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


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread: beside the suite's other workers a thread pool per
    op oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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


# ------------------------------------------------ XLA's path (reference_attention)
def _ref_inputs(layout, mask, seed=4, B=2, H=3, L=19, d=32):
    rng = np.random.RandomState(seed)
    shape = (B, H, L, d) if layout == "bhld" else (B, L, H, d)
    q, k, v = (rng.randn(*shape).astype(np.float32) for _ in range(3))
    m = {None: None,
         "causal": np.triu(np.full((L, L), -np.inf, np.float32), 1),
         "bcast": np.where(rng.rand(B, 1, 1, L) < 0.3, -1e9, 0.0).astype(np.float32)}[mask]
    return q, k, v, m


@pytest.mark.parametrize("bf16_env", [None, "0"], ids=["unset", "off"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mask", [None, "causal", "bcast"], ids=["nomask", "causal", "bcast"])
@pytest.mark.parametrize("layout", ["bhld", "blhd"])
def test_reference_attention_matches_jax_xla_path(layout, mask, dtype, bf16_env, monkeypatch):
    """reference_attention / reference_attention_blhd against JAX's
    _reference_attention / _reference_attention_blhd on the same inputs,
    with FSVLM_ATTN_BF16 unset (bf16: S and P stay bf16) and "0" (fp32 S and
    softmax): fp32 at rtol 1e-5 / atol 1e-6; bf16 at atol 2^-7 of the largest
    |O| (one bf16 ulp is 2^-8 relative; the two softmaxes round apart)."""
    import fsvlm_tpu.ops.flash_attention as jax_fa

    if bf16_env is None:
        monkeypatch.delenv("FSVLM_ATTN_BF16", raising=False)
    else:
        monkeypatch.setenv("FSVLM_ATTN_BF16", bf16_env)
    q, k, v, m = _ref_inputs(layout, mask)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jax_fn, fn = ((jax_fa._reference_attention, flash_attention.reference_attention)
                  if layout == "bhld" else
                  (jax_fa._reference_attention_blhd, flash_attention.reference_attention_blhd))
    ref = jax_fn(*(jnp.asarray(t, jdt) for t in (q, k, v)),
                 None if m is None else jnp.asarray(m), q.shape[-1] ** -0.5)
    tdt = getattr(torch, dtype)
    out = fn(*(torch.from_numpy(t).to(tdt) for t in (q, k, v)),
             None if m is None else torch.from_numpy(m))
    assert out.dtype == tdt and out.shape == q.shape
    ref = np.asarray(ref.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_allclose(out.float().numpy(), ref, rtol=0,
                                   atol=2 ** -7 * np.abs(ref).max())


def test_broadcast_mask_takes_xla_path_on_the_unset_route(monkeypatch):
    """With FSVLM_FORCE_PALLAS unset, a (B, 1, 1, L) key-bias mask routes to
    "reference" (no kernel takes it), and attention_dispatch gives JAX's
    attention_dispatch result (rtol 1e-5 / atol 1e-6) and launches nothing."""
    import fsvlm_tpu.ops.flash_attention as jax_fa

    monkeypatch.delenv("FSVLM_FORCE_PALLAS", raising=False)
    q, k, v, m = _ref_inputs("bhld", "bcast", d=64)
    assert flash_attention.attention_route(64, torch.from_numpy(m), heads=3) == "reference"
    before = dict(flash_attention.LAUNCHES)
    out = flash_attention.attention_dispatch(*(torch.from_numpy(t) for t in (q, k, v, m)))
    ref = jax_fa.attention_dispatch(*(jnp.asarray(t) for t in (q, k, v, m)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
    assert flash_attention.LAUNCHES == before


@pytest.mark.parametrize("remat", [None, "1"], ids=["kept", "remat"])
def test_reference_route_gradients_match_jax(remat, monkeypatch):
    """First and second derivatives through the broadcast-mask route, with
    FSVLM_ATTN_REMAT unset and "1" (checkpointed: the backward recomputes
    S and P), against jax.grad of JAX's attention_dispatch under the same
    variable (fp32, rtol 1e-4 / atol 1e-6 of the largest entry).  The second
    derivative (d/dq of <dL/dk, w>, what PLIP's grad mode needs) is held
    against JAX's the same way."""
    import jax

    import fsvlm_tpu.ops.flash_attention as jax_fa

    monkeypatch.delenv("FSVLM_FORCE_PALLAS", raising=False)
    if remat is None:
        monkeypatch.delenv("FSVLM_ATTN_REMAT", raising=False)
    else:
        monkeypatch.setenv("FSVLM_ATTN_REMAT", remat)
    q, k, v, m = _ref_inputs("bhld", "bcast", d=64)
    rng = np.random.RandomState(7)
    g, w = rng.randn(*q.shape).astype(np.float32), rng.randn(*q.shape).astype(np.float32)

    def jax_loss(q_, k_, v_):
        return jnp.sum(jax_fa.attention_dispatch(q_, k_, v_, jnp.asarray(m)) * g)

    jq, jk, jv = (jnp.asarray(t) for t in (q, k, v))
    ref = jax.grad(jax_loss, argnums=(0, 1, 2))(jq, jk, jv)
    ref2 = jax.grad(lambda q_: jnp.sum(jax.grad(jax_loss, argnums=1)(q_, jk, jv) * w))(jq)

    tq, tk, tv = (torch.from_numpy(t).requires_grad_() for t in (q, k, v))
    out = flash_attention.attention_dispatch(tq, tk, tv, torch.from_numpy(m))
    grads = torch.autograd.grad((out * torch.from_numpy(g)).sum(), (tq, tk, tv),
                                create_graph=True)
    (second,) = torch.autograd.grad((grads[1] * torch.from_numpy(w)).sum(), tq)
    for got, want in zip(grads + (second,), ref + (ref2,)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4,
                                   atol=1e-6 * np.abs(want).max())
