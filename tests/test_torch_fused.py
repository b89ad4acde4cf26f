"""The port's whole-sequence attention (kernels #1-#2) and the dispatch
routes that reach it, against the JAX package, on the CPU.

The plain versions of the whole-sequence Hopper kernels run here (CPU
tensors); the JAX side is ``fsvlm_tpu.ops.flash_attention.fused_attention``
with ``interpret=True``, whose forward and custom-VJP backward run the Pallas
kernels ``_attn_kernel`` and ``_attn_bwd_kernel`` in interpret mode, as
tests/test_flash_attention.py:27,40 runs them.  Inputs come from numpy seeds.
fp32 at that file's tolerances (rtol 2e-4 / atol 2e-5); bf16 as each test
states.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fsvlm_tpu.ops import attention as jax_attention
from fsvlm_tpu.ops import flash_attention as jax_fa
from fsvlm_tpu_torch.ops import attention, flash_attention

fa = flash_attention


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread: beside the suite's other workers a thread pool per
    op oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(B, H, L, d, seed, n=3):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, H, L, d).astype(np.float32) for _ in range(n)]


def _jax_fused(q, k, v, mask):
    return jax_fa.fused_attention(q, k, v, mask, True)


@pytest.mark.parametrize("L,d,with_mask", [
    (77, 64, True), (197, 64, False), (13, 32, False),  # tests/test_flash_attention.py:17
    (8, 64, True), (16, 64, True), (24, 64, True), (201, 64, False),  # text and vision lengths
])
def test_fused_forward_matches_jax_pallas(L, d, with_mask):
    q, k, v = _inputs(2, 2, L, d, seed=L)
    mask_j = jax_attention.causal_mask(L) if with_mask else None
    ref = _jax_fused(q, k, v, mask_j)
    mask_t = attention.causal_mask(L, device="cpu") if with_mask else None
    got = fa.fused_attention(*map(torch.from_numpy, (q, k, v)), mask_t)
    assert got.shape == (2, 2, L, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-4, atol=2e-5)


def _bf16_ulp(x):
    """One bf16 ulp at |x| (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(np.abs(x))) - 7)


@pytest.mark.parametrize("L,d,with_mask", [(77, 64, True), (201, 64, False), (24, 32, True)])
def test_fused_forward_bf16_matches_jax_pallas(L, d, with_mask):
    """bf16 inputs: P normalized in fp32, then rounded to bf16 before P.V, in
    both.  Tolerance: two bf16 ulps at the largest |O|, the size of the
    rounding that separates two fp32 sums of different order."""
    q, k, v = (x.astype(jnp.bfloat16) for x in map(jnp.asarray, _inputs(2, 2, L, d, seed=L + 1)))
    mask_j = jax_attention.causal_mask(L) if with_mask else None
    ref = np.asarray(_jax_fused(q, k, v, mask_j).astype(jnp.float32))
    t = [torch.tensor(np.asarray(x.astype(jnp.float32))).bfloat16() for x in (q, k, v)]
    got = fa.fused_attention(*t, attention.causal_mask(L, device="cpu") if with_mask else None)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0,
                               atol=2 * _bf16_ulp(np.abs(ref).max()))


@pytest.mark.parametrize("B,H,L,d", [(1, 2, 29, 32), (2, 2, 77, 64)])
def test_fused_gradients_match_jax_custom_vjp(B, H, L, d):
    """dq, dk, dv of a weighted sum through the causal mask, against JAX's
    custom VJP (the Pallas backward in interpret mode)."""
    q, k, v, w = _inputs(B, H, L, d, seed=7, n=4)
    mask_j = jax_attention.causal_mask(L)
    ref = jax.grad(lambda a, b, c: (_jax_fused(a, b, c, mask_j) * w).sum(),
                   argnums=(0, 1, 2))(q, k, v)
    qkv = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    o = fa.fused_attention(*qkv, attention.causal_mask(L, device="cpu"))
    got = torch.autograd.grad(o, qkv, torch.from_numpy(w))
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4, atol=2e-5, err_msg=name)


def test_fused_bf16_backward_takes_delta_from_the_unrounded_p():
    """In bf16, JAX's backward takes delta = rowsum(dP * P) from the fp32 P
    it recomputes; the port's plain backward does the same and lands on
    JAX's gradients.  The flash rule, delta = rowsum(dO * O) from the
    rounded O, lands measurably further away: the two deltas differ in bf16."""
    B, H, L, d = 2, 2, 77, 64
    q, k, v, g = (jnp.asarray(x).astype(jnp.bfloat16) for x in _inputs(B, H, L, d, seed=8, n=4))
    mask_j = jax_attention.causal_mask(L)
    _, vjp = jax.vjp(lambda a, b, c: _jax_fused(a, b, c, mask_j), q, k, v)
    ref = [np.asarray(x.astype(jnp.float32)) for x in vjp(g)]

    t = [torch.tensor(np.asarray(x.astype(jnp.float32))).bfloat16() for x in (q, k, v, g)]
    mask = attention.causal_mask(L, device="cpu")
    got = fa.reference_fused_bwd(*t, mask)
    # the flash rule on the same inputs: delta from the rounded forward output
    qf, kf, vf, gf = (x.float() for x in t)
    p = torch.softmax(qf @ kf.transpose(-1, -2) * d ** -0.5 + mask, dim=-1)
    o = fa.reference_fused_fwd(*t[:3], mask)
    ds = p * (gf @ vf.transpose(-1, -2) - (gf * o.float()).sum(-1, keepdim=True))
    flash_dq = ((ds @ kf) * d ** -0.5).bfloat16()

    err = np.abs(got[0].float().numpy() - ref[0]).mean()
    err_flash = np.abs(flash_dq.float().numpy() - ref[0]).mean()
    scale = np.abs(ref[0]).max()
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        np.testing.assert_allclose(a.float().numpy(), b, rtol=0,
                                   atol=2 * _bf16_ulp(np.abs(b).max()), err_msg=name)
    assert err < err_flash / 100 and err_flash > 1e-5 * scale, (err, err_flash, scale)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "nomask"])
def test_fused_plain_gradcheck_float64(causal):
    """The plain whole-sequence backward is the derivative of the plain
    forward: float64, L = 70, head dim 8."""
    rng = np.random.RandomState(5)
    q, k, v = [torch.from_numpy(rng.randn(1, 2, 70, 8)).requires_grad_() for _ in range(3)]
    mask = attention.causal_mask(70, dtype=torch.float64, device="cpu") if causal else None
    assert torch.autograd.gradcheck(lambda a, b, c: fa.fused_attention(a, b, c, mask), (q, k, v),
                                    fast_mode=True)


def test_fully_masked_row_gives_nan_as_jax_does_at_a_multiple_of_128():
    """A row whose every key is -inf: the port's plain version (and kernel)
    gives NaN.  JAX gives NaN too when L is a multiple of 128; below it, its
    padded keys (-1e30, finite) take the row's weight and O = 0.  The port
    does not pad, so it keeps the NaN at every L (not on any path: every
    causal row has its diagonal)."""
    for L in (128, 10):
        q, k, v = _inputs(1, 1, L, 16, seed=2)
        mask = np.zeros((L, L), np.float32)
        mask[3] = -np.inf
        ref = np.asarray(_jax_fused(q, k, v, jnp.asarray(mask)))
        got = fa.fused_attention(*map(torch.from_numpy, (q, k, v)), torch.from_numpy(mask)).numpy()
        assert np.isnan(got[0, 0, 3]).all()
        assert np.isnan(ref[0, 0, 3]).all() if L == 128 else (ref[0, 0, 3] == 0).all()
        keep = np.arange(L) != 3
        np.testing.assert_allclose(got[0, 0, keep], ref[0, 0, keep], rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "nomask"])
def test_mha_under_legacy_matches_jax(causal, monkeypatch):
    """mha and d(mha)/dx under FSVLM_FORCE_PALLAS=legacy in both packages:
    the port's whole-sequence plain versions against JAX's Pallas
    ``fused_attention`` in interpret mode (rtol 1e-4 / atol 1e-5)."""
    monkeypatch.setenv("FSVLM_FORCE_PALLAS", "legacy")
    rng = np.random.RandomState(2)
    B, L, D, H = 2, 13, 256, 4
    assert fa.attention_route(D // H) == "fused"
    x = rng.randn(B, L, D).astype(np.float32)
    w_qkv = (rng.randn(D, 3 * D) * D ** -0.5).astype(np.float32)
    b_qkv = (0.1 * rng.randn(3 * D)).astype(np.float32)
    w_out = (rng.randn(D, D) * D ** -0.5).astype(np.float32)
    b_out = (0.1 * rng.randn(D)).astype(np.float32)
    g = rng.randn(B, L, D).astype(np.float32)
    mask_j = jax_attention.causal_mask(L) if causal else None
    ref_out, vjp = jax.vjp(
        lambda x_: jax_attention.mha(x_, w_qkv, b_qkv, w_out, b_out, H, mask=mask_j), x)
    ref_dx, = vjp(jnp.asarray(g))
    t = torch.from_numpy
    xt = t(x).requires_grad_()
    out = attention.mha(xt, t(w_qkv), t(b_qkv), t(w_out), t(b_out), H,
                        mask=attention.causal_mask(L, device="cpu") if causal else None)
    dx, = torch.autograd.grad(out, xt, t(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(dx.numpy(), np.asarray(ref_dx), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("force", ["1", "packed", "legacy"])
def test_broadcast_mask_raises_value_error_in_both_packages(force, monkeypatch):
    """A per-example (B, 1, 1, L) key-bias mask under each value that routes
    to ``fused_attention`` in JAX: JAX raises ValueError (its (Lp, Lp) mask
    cannot take it), and the port raises ValueError too."""
    monkeypatch.setenv("FSVLM_FORCE_PALLAS", force)
    q, k, v = _inputs(3, 2, 10, 64, seed=4)
    bias = np.zeros((3, 1, 1, 10), np.float32)
    bias[0, ..., 7:] = -1e30
    with pytest.raises(ValueError):
        jax_fa.attention_dispatch(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bias))
    t = [torch.from_numpy(x) for x in (q, k, v)]
    with pytest.raises(ValueError, match="cannot take it"):
        fa.attention_dispatch(*t, torch.from_numpy(bias))
    with pytest.raises(ValueError):
        fa.fused_attention(*t, torch.from_numpy(bias))


def test_fused_rejects_head_dims_above_128(monkeypatch):
    """Head dims past 128 are no longer refused: at d = 136 fused_attention
    and the ``legacy`` route give JAX's fused_attention in interpret mode
    (rtol 2e-4 / atol 2e-5); a head dim of 0 and an unknown ``impl`` still
    raise."""
    q, k, v = _inputs(1, 2, 8, 136, seed=11)
    ref = np.asarray(_jax_fused(q, k, v, None))
    t = [torch.from_numpy(x) for x in (q, k, v)]
    np.testing.assert_allclose(fa.fused_attention(*t).numpy(), ref, rtol=2e-4, atol=2e-5)
    monkeypatch.setenv("FSVLM_FORCE_PALLAS", "legacy")
    np.testing.assert_allclose(fa.attention_dispatch(*t).numpy(), ref, rtol=2e-4, atol=2e-5)
    with pytest.raises(ValueError, match=">= 1"):
        fa.fused_attention(*(torch.zeros(1, 2, 8, 0),) * 3)
    with pytest.raises(ValueError):
        fa.fused_attention(t[0][..., :32], t[1][..., :32], t[2][..., :32], impl="kernel")


_WIDE = [(d, L, causal) for d in (192, 256, 320) for L in (13, 77) for causal in (True, False)]


@pytest.mark.parametrize("d,L,causal", _WIDE, ids=[
    f"d{d}_L{L}_{'causal' if c else 'nomask'}" for d, L, c in _WIDE])
def test_fused_wide_head_dims_match_jax_pallas(d, L, causal):
    """Head dims past 128 (the D = 192 and 256 instantiations, and 320 in
    two column passes of 256 on the card): the forward and the three
    gradients of a weighted sum against JAX's fused_attention and its
    custom VJP, the Pallas kernels in interpret mode, which pad d to a
    multiple of 128; fp32, forward rtol 2e-4 / atol 2e-5, gradients rtol
    2e-4 / atol 2e-4.  And the plain versions against autograd through a
    one-shot softmax attention."""
    q, k, v, w = _inputs(1, 2, L, d, seed=d + L + 7 * causal, n=4)
    mask_j = jax_attention.causal_mask(L) if causal else None

    @jax.jit
    def fwd_grads(q_, k_, v_):
        o, vjp = jax.vjp(lambda a, b, c: _jax_fused(a, b, c, mask_j), q_, k_, v_)
        return o, vjp(w)

    ref_o, ref = fwd_grads(q, k, v)
    qkv = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    mask_t = attention.causal_mask(L, device="cpu") if causal else None
    o = fa.fused_attention(*qkv, mask_t)
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(ref_o), rtol=2e-4, atol=2e-5)
    got = torch.autograd.grad(o, qkv, torch.from_numpy(w))
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4, atol=2e-4, err_msg=name)
    plain = [t.detach().clone().requires_grad_() for t in qkv]
    s = plain[0] @ plain[1].transpose(-1, -2) * d ** -0.5
    out = torch.softmax(s if mask_t is None else s + mask_t, dim=-1) @ plain[2]
    want = torch.autograd.grad(out, plain, torch.from_numpy(w))
    torch.testing.assert_close(o.detach(), out.detach(), rtol=1e-4, atol=1e-5)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


def test_fused_operators_fake_implementation_build_and_cpu_path():
    """``torch.ops.fsvlm.fused_attn_fwd`` / ``fused_attn_bwd`` are CUDA-only
    operators with fake implementations: O and the gradients in q's shape
    and dtype, laid out (B, L, H, d).  CPU tensors take the plain versions
    and count no launch; build.py names both sources, which share the
    header the blockwise kernels use."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from fsvlm_tpu_torch.ops.kernels import build

    with FakeTensorMode():
        q = torch.empty(2, 3, 10, 80, dtype=torch.bfloat16)
        o = torch.ops.fsvlm.fused_attn_fwd(q, q, q, None)
        grads = torch.ops.fsvlm.fused_attn_bwd(q, q, q, q, None)
    for t in (o, *grads):
        assert t.shape == (2, 3, 10, 80) and t.dtype == torch.bfloat16
        assert t.transpose(1, 2).is_contiguous()
    q = torch.zeros(1, 2, 4, 32)
    with pytest.raises(NotImplementedError):  # no CPU kernel
        torch.ops.fsvlm.fused_attn_fwd(q, q, q, None)
    before = dict(fa.LAUNCHES)
    qg = q.clone().requires_grad_()
    fa.fused_attention(qg, q, q).sum().backward()
    assert qg.grad is not None and fa.LAUNCHES == before
    assert build.SOURCES["fused_attn_fwd"] == "fused_attn_fwd.cu"
    assert build.SOURCES["fused_attn_bwd"] == "fused_attn_bwd.cu"
    for name in ("fused_attn_fwd", "fused_attn_bwd"):
        with open(f"{build.KERNEL_DIR}/{build.SOURCES[name]}") as fh:
            assert '#include "blockwise_attn.cuh"' in fh.read()
    assert {fa.FUSED_KERNEL, fa.FUSED_KERNEL_STATS, fa.FUSED_KERNEL_DKV,
            fa.FUSED_KERNEL_DQ} <= set(fa.LAUNCHES)
