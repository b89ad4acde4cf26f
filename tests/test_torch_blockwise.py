"""The port's blockwise attention (kernels #3-#5) and the attention dispatch,
against the JAX package, on the CPU.

The plain versions of the blockwise Hopper kernels run here (CPU tensors);
the JAX side is ``fsvlm_tpu.ops.flash_attention.blockwise_attention`` with
``interpret=True``, whose forward and custom-VJP backward run the Pallas
kernels ``_blockwise_fwd_kernel``, ``_blockwise_dkv_kernel`` and
``_blockwise_dq_kernel`` in interpret mode, as the JAX package's own tests
run them.  Inputs come from numpy seeds; fp32, at the tolerances of
tests/test_flash_attention.py: forward rtol 2e-4 / atol 2e-5, gradients
rtol 2e-4 / atol 2e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fsvlm_tpu.ops import attention as jax_attention
from fsvlm_tpu.ops.flash_attention import blockwise_attention as jax_blockwise
from fsvlm_tpu_torch.ops import attention, flash_attention


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


@pytest.mark.parametrize("L,d,with_mask,bq,bk", [
    (77, 64, True, 256, 512),    # the four cases of tests/test_flash_attention.py:51-58
    (201, 64, False, 256, 512),
    (300, 32, True, 128, 128),
    (513, 64, True, 256, 128),
    (77, 128, True, 256, 512),   # the largest instantiation
    (130, 80, True, 128, 128),   # zero-padded to the 128 instantiation
], ids=["text77", "vision201", "d32_L300", "L513", "d128", "d80"])
def test_blockwise_forward_matches_jax_pallas(L, d, with_mask, bq, bk):
    q, k, v = _inputs(2, 2, L, d, seed=5)
    mask_j = jax_attention.causal_mask(L) if with_mask else None
    ref = jax.jit(lambda a, b, c: jax_blockwise(a, b, c, mask_j, bq, bk, True))(q, k, v)
    mask_t = attention.causal_mask(L, device="cpu") if with_mask else None
    got = flash_attention.blockwise_attention(*map(torch.from_numpy, (q, k, v)), mask_t, bq, bk)
    assert got.shape == (2, 2, L, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("L,d,bq,bk", [
    (77, 32, 256, 512),   # tests/test_flash_attention.py:73-94's two cases
    (300, 32, 128, 128),
    (77, 80, 256, 512),   # a padded head dim
])
def test_blockwise_gradients_match_jax_pallas(L, d, bq, bk):
    q, k, v, w = _inputs(1, 2, L, d, seed=6, n=4)
    mask_j = jax_attention.causal_mask(L)

    @jax.jit
    def grads(q_, k_, v_):
        return jax.grad(lambda a, b, c: (jax_blockwise(a, b, c, mask_j, bq, bk, True) * w).sum(),
                        argnums=(0, 1, 2))(q_, k_, v_)

    ref = grads(q, k, v)
    qkv = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    o = flash_attention.blockwise_attention(*qkv, attention.causal_mask(L, device="cpu"), bq, bk)
    got = torch.autograd.grad(o, qkv, torch.from_numpy(w))
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4, atol=2e-4, err_msg=name)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "nomask"])
@pytest.mark.parametrize("L", [77, 201])
@pytest.mark.parametrize("d", [32, 64, 80, 128])
def test_blockwise_gradients_match_jax_pallas_bf16(d, L, causal):
    """bf16: the same numpy draws rounded to bf16 through the port's plain
    blockwise forward and backward (the versions that the card holds
    kernels #3-#5 to) and through JAX's blockwise forward and Pallas
    backward in interpret mode, each in bf16.  Each gradient's max abs
    error within 1e-2 of JAX's largest gradient (chip_smoke.py's bf16
    backward limit: an output ulp is 2^-8 relative)."""
    q, k, v, do = [torch.from_numpy(t).bfloat16()
                   for t in _inputs(1, 2, L, d, seed=L + d + 7 * causal, n=4)]
    mask_j = jax_attention.causal_mask(L) if causal else None

    @jax.jit
    def grads(q_, k_, v_, do_):
        _, vjp = jax.vjp(lambda a, b, c: jax_blockwise(a, b, c, mask_j, 256, 512, True),
                         q_, k_, v_)
        return vjp(do_)

    ref = grads(*[jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (q, k, v, do)])
    want = [np.asarray(r.astype(jnp.float32)) for r in ref]
    qkv = [t.requires_grad_() for t in (q, k, v)]
    mask_t = attention.causal_mask(L, device="cpu") if causal else None
    o = flash_attention.blockwise_attention(*qkv, mask_t)
    got = torch.autograd.grad(o, qkv, do)
    scale = max(np.abs(w).max() for w in want)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16, name
        err = np.abs(g.float().numpy() - w).max() / scale
        assert err <= 1e-2, (name, err)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "nomask"])
def test_mha_under_force_pallas_matches_jax(causal, monkeypatch):
    """mha and d(mha)/dx with FSVLM_FORCE_PALLAS=1 in both packages, at head
    dim 64, where the variable moves the port off its d = 64 kernels: the
    port's blockwise plain versions against JAX's blockwise Pallas kernels in
    interpret mode (rtol 1e-4 / atol 1e-5)."""
    monkeypatch.setenv("FSVLM_FORCE_PALLAS", "1")
    rng = np.random.RandomState(2)
    B, L, D, H = 2, 13, 256, 4
    assert flash_attention.attention_route(D // H) == "blockwise"
    x = rng.randn(B, L, D).astype(np.float32)
    w_qkv = (rng.randn(D, 3 * D) * D ** -0.5).astype(np.float32)
    b_qkv = (0.1 * rng.randn(3 * D)).astype(np.float32)
    w_out = (rng.randn(D, D) * D ** -0.5).astype(np.float32)
    b_out = (0.1 * rng.randn(D)).astype(np.float32)
    g = rng.randn(B, L, D).astype(np.float32)
    mask_j = jax_attention.causal_mask(L) if causal else None

    def f(x_):
        return jax_attention.mha(x_, w_qkv, b_qkv, w_out, b_out, H, mask=mask_j)

    ref_out, vjp = jax.vjp(f, x)
    ref_dx, = vjp(jnp.asarray(g))
    t = torch.from_numpy
    xt = t(x).requires_grad_()
    out = attention.mha(xt, t(w_qkv), t(b_qkv), t(w_out), t(b_out), H,
                        mask=attention.causal_mask(L, device="cpu") if causal else None)
    dx, = torch.autograd.grad(out, xt, t(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(dx.numpy(), np.asarray(ref_dx), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "nomask"])
def test_blockwise_plain_gradcheck_float64(causal):
    """The plain blockwise backward is the derivative of the plain forward:
    float64, L = 70 (two key tiles), head dim 8 (padded to 32 on the card)."""
    rng = np.random.RandomState(5)
    q, k, v = [torch.from_numpy(rng.randn(1, 2, 70, 8)).requires_grad_() for _ in range(3)]
    mask = attention.causal_mask(70, dtype=torch.float64, device="cpu") if causal else None
    assert torch.autograd.gradcheck(
        lambda q_, k_, v_: flash_attention.blockwise_attention(q_, k_, v_, mask), (q, k, v),
        fast_mode=True)


_WIDE = [(d, L, causal) for d in (192, 256, 320) for L in (13, 77) for causal in (True, False)]


@pytest.mark.parametrize("d,L,causal", _WIDE, ids=[
    f"d{d}_L{L}_{'causal' if c else 'nomask'}" for d, L, c in _WIDE])
def test_blockwise_wide_head_dims_match_jax_pallas(d, L, causal):
    """Head dims past 128 (the D = 192 and 256 instantiations, and 320 in
    two column passes of 256 on the card): the forward and the three
    gradients of a weighted sum against JAX's blockwise forward and Pallas
    backward in interpret mode, which pad d to a multiple of 128; fp32,
    forward rtol 2e-4 / atol 2e-5, gradients rtol 2e-4 / atol 2e-4."""
    q, k, v, w = _inputs(1, 2, L, d, seed=d + L + 7 * causal, n=4)
    mask_j = jax_attention.causal_mask(L) if causal else None

    @jax.jit
    def fwd_grads(q_, k_, v_):
        o, vjp = jax.vjp(lambda a, b, c: jax_blockwise(a, b, c, mask_j, 256, 512, True),
                         q_, k_, v_)
        return o, vjp(w)

    ref_o, ref = fwd_grads(q, k, v)
    qkv = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    mask_t = attention.causal_mask(L, device="cpu") if causal else None
    o = flash_attention.blockwise_attention(*qkv, mask_t)
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(ref_o), rtol=2e-4, atol=2e-5)
    got = torch.autograd.grad(o, qkv, torch.from_numpy(w))
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4, atol=2e-4, err_msg=name)


@pytest.mark.parametrize("force", [None, "1", "legacy"], ids=["unset", "1", "legacy"])
@pytest.mark.parametrize("d", [192, 256, 320])
def test_dispatch_at_wide_head_dims_matches_jax(d, force, monkeypatch):
    """attention_dispatch past head dim 128 gives JAX's attention_dispatch's
    result under FSVLM_FORCE_PALLAS unset (JAX: XLA's attention; the port:
    its blockwise kernels, not a detour to reference_attention), ``1`` (both
    blockwise) and ``legacy`` (both whole-sequence), at rtol 2e-4 / atol
    2e-5.  The port's route is its kernel family under every value."""
    import fsvlm_tpu.ops.flash_attention as jax_fa

    if force is None:
        monkeypatch.delenv("FSVLM_FORCE_PALLAS", raising=False)
    else:
        monkeypatch.setenv("FSVLM_FORCE_PALLAS", force)
    L = 9
    q, k, v = _inputs(1, 2, L, d, seed=d + 1)
    mask = attention.causal_mask(L, device="cpu")
    want = "fused" if force == "legacy" else "blockwise"
    assert flash_attention.attention_route(d, mask, heads=2) == want
    ref = jax_fa.attention_dispatch(q, k, v, jax_attention.causal_mask(L))
    got = flash_attention.attention_dispatch(*map(torch.from_numpy, (q, k, v)), mask)
    assert got.shape == (1, 2, L, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("d", [32, 64, 80, 128, 192, 256, 320])
def test_blockwise_plain_versions_walk_the_kernel_tiles_like_plain_autograd(d):
    """reference_blockwise_fwd / _bwd against autograd through a one-shot
    softmax attention (independent of the tiling), with a fully masked row:
    its O and gradients are 0."""
    fa = flash_attention
    q, k, v, do = [torch.from_numpy(t) for t in _inputs(2, 2, 130, d, seed=3, n=4)]
    mask = torch.from_numpy(np.random.RandomState(4).randn(130, 130).astype(np.float32))
    mask[7] = float("-inf")
    o, lse = fa.reference_blockwise_fwd(q, k, v, mask)
    dq, dk, dv = fa.reference_blockwise_bwd(q, k, v, o, lse, do, mask)
    qkv = [t.clone().requires_grad_() for t in (q, k, v)]
    s = qkv[0] @ qkv[1].transpose(-1, -2) * d ** -0.5 + mask
    p = torch.softmax(s.masked_fill(torch.isinf(mask), -1e30), dim=-1).masked_fill(
        torch.isinf(mask), 0.0)
    out = p @ qkv[2]
    ref = torch.autograd.grad(out, qkv, do)
    torch.testing.assert_close(o, out.detach(), rtol=1e-4, atol=1e-5)
    for got, want in zip((dq, dk, dv), ref):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    assert o[:, :, 7].abs().max().item() == 0.0 and dq[:, :, 7].abs().max().item() == 0.0


# ------------------------------------------------------------------ dispatch
_BCAST = "bcast"  # a per-example (B, 1, 1, L) key-bias mask
# ValueError: the mask reaches the whole-sequence family, as in JAX, which raises
_RAISES = {ValueError: "cannot take it"}


@pytest.mark.parametrize("force,d,mask,want", [
    (None, 64, None, "packed"), (None, 64, "2d", "packed"), (None, 32, "2d", "blockwise"),
    (None, 80, None, "blockwise"), (None, 64, _BCAST, "reference"),
    ("packed", 64, "2d", "blockwise"), ("packed", 128, None, "blockwise"),
    ("packed", 64, _BCAST, ValueError),
    ("1", 64, None, "blockwise"), ("1", 64, "2d", "blockwise"), ("1", 32, "2d", "blockwise"),
    ("1", 64, _BCAST, ValueError),
    ("legacy", 64, None, "fused"), ("legacy", 32, "2d", "fused"), ("legacy", 64, _BCAST, ValueError),
    ("legacy", 80, "2d", "fused"),
    ("0", 64, "2d", "packed"), ("0", 128, None, "blockwise"), ("anything", 64, None, "packed"),
])
def test_dispatch_routes_by_force_pallas_and_head_dim(force, d, mask, want, monkeypatch):
    """attention_dispatch reads FSVLM_FORCE_PALLAS at each call and runs the
    family attention_route names (a stub per family marks which ran):
    ``legacy`` takes the whole-sequence family; ``packed`` the blockwise one
    at this q's odd head count (3), as JAX does; a broadcast mask raises
    ValueError under ``1``, ``packed`` and ``legacy`` (as JAX's
    fused_attention does), and takes XLA's path (``reference_attention``,
    no kernel family) on the port's default route."""
    fa = flash_attention
    if force is None:
        monkeypatch.delenv("FSVLM_FORCE_PALLAS", raising=False)
    else:
        monkeypatch.setenv("FSVLM_FORCE_PALLAS", force)
    ran = []

    def stub(family):
        def fwd(q, k, v, m):
            ran.append(family)
            return q.clone() if family == "fused" else (q.clone(), q.new_zeros(q.shape[:3]))
        return fwd

    monkeypatch.setattr(fa, "_FAMILIES", {f: (stub(f),) + t[1:] for f, t in fa._FAMILIES.items()})
    q = torch.zeros(2, 3, 8, d)
    m = {None: None, "2d": torch.zeros(8, 8), _BCAST: torch.zeros(2, 1, 1, 8)}[mask]
    if want in _RAISES:
        with pytest.raises(want, match=_RAISES[want]):
            fa.attention_route(d, m, heads=q.shape[1])
        with pytest.raises(want, match=_RAISES[want]):
            fa.attention_dispatch(q, q, q, m)
        assert ran == []
        return
    assert fa.attention_route(d, m, heads=q.shape[1]) == want
    o = fa.attention_dispatch(q, q, q, m)
    assert ran == ([] if want == "reference" else [want]) and o.shape == q.shape
    if want == "reference":
        torch.testing.assert_close(o, fa.reference_attention(q, q, q, m), rtol=0, atol=0)


@pytest.mark.parametrize("H,want", [(3, "blockwise"), (1, "blockwise"), (2, "packed"),
                                    (12, "packed")])
def test_packed_route_follows_the_head_count_as_jax(H, want, monkeypatch):
    """Under FSVLM_FORCE_PALLAS=packed, at d = 64, both packages take the
    head-packed kernels only at an even head count and the blockwise ones at
    an odd one (JAX :872-879): JAX's attention_dispatch, with its two entries
    wrapped at run time to record which one ran, the port's route and the
    family its dispatch runs agree, and so do the outputs (fp32: the port's
    plain version against JAX's Pallas kernel in interpret mode, rtol 2e-4 /
    atol 2e-5)."""
    import fsvlm_tpu.ops.flash_attention as jax_fa

    fa = flash_attention
    monkeypatch.setenv("FSVLM_FORCE_PALLAS", "packed")
    ran = {"jax": [], "port": []}
    for name in ("blockwise_attention", "packed_attention"):
        def record(*args, _real=getattr(jax_fa, name), _family=name.split("_")[0]):
            ran["jax"].append(_family)
            return _real(*args)

        monkeypatch.setattr(jax_fa, name, record)

    def recorded(family, plain_fwd):
        def fwd(*args):
            ran["port"].append(family)
            return plain_fwd(*args)
        return fwd

    monkeypatch.setattr(fa, "_FAMILIES", {f: (recorded(f, t[0]),) + t[1:]
                                          for f, t in fa._FAMILIES.items()})
    L = 13
    q, k, v = _inputs(1, H, L, 64, seed=20 + H)
    ref = jax_fa.attention_dispatch(q, k, v, jax_attention.causal_mask(L))
    mask = attention.causal_mask(L, device="cpu")
    assert fa.attention_route(64, mask, heads=H) == want
    got = fa.attention_dispatch(*map(torch.from_numpy, (q, k, v)), mask)
    assert ran == {"jax": [want], "port": [want]}
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-4, atol=2e-5)


def test_blockwise_rejects_what_it_does_not_take():
    """Bad tile sizes and ``impl`` raise; a head dim past 128 (136, in the
    D = 192 instantiation on the card) no longer does: it gives JAX's
    blockwise forward in interpret mode (rtol 2e-4 / atol 2e-5)."""
    q, k, v = _inputs(1, 2, 8, 136, seed=9)
    ref = jax_blockwise(q, k, v, None, 256, 512, True)
    got = flash_attention.blockwise_attention(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-4, atol=2e-5)
    with pytest.raises(ValueError, match=">= 1"):
        flash_attention.blockwise_attention(*(torch.zeros(1, 2, 8, 0),) * 3)
    q = torch.zeros(1, 2, 8, 32)
    for bad in ({"block_q": 0}, {"block_k": 1.5}):
        with pytest.raises(ValueError):
            flash_attention.blockwise_attention(q, q, q, **bad)
    with pytest.raises(ValueError):
        flash_attention.blockwise_attention(q, q, q, impl="kernel")


def test_blockwise_operators_fake_implementation_and_cpu_path():
    """``torch.ops.fsvlm.blockwise_attn_fwd`` / ``blockwise_attn_bwd`` are
    CUDA-only operators with fake implementations: O and the gradients in
    q's shape and dtype, laid out (B, L, H, d), LSE (B, H, L) fp32.  CPU
    tensors take the plain versions and count no launch."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    fa = flash_attention
    with FakeTensorMode():
        q = torch.empty(2, 3, 10, 80, dtype=torch.bfloat16)
        o, lse = torch.ops.fsvlm.blockwise_attn_fwd(q, q, q, None)
        grads = torch.ops.fsvlm.blockwise_attn_bwd(q, q, q, q, lse, lse, None)
    assert lse.shape == (2, 3, 10) and lse.dtype == torch.float32
    for t in (o, *grads):
        assert t.shape == (2, 3, 10, 80) and t.dtype == torch.bfloat16
        assert t.transpose(1, 2).is_contiguous()
    q = torch.zeros(1, 2, 4, 32)
    with pytest.raises(NotImplementedError):  # no CPU kernel
        torch.ops.fsvlm.blockwise_attn_fwd(q, q, q, None)
    before = dict(fa.LAUNCHES)
    qg = q.clone().requires_grad_()
    fa.blockwise_attention(qg, q, q).sum().backward()
    assert qg.grad is not None and fa.LAUNCHES == before


def test_library_path_hashes_sources_and_headers(tmp_path, monkeypatch):
    """A library's name hashes its source, every header in the kernel
    directory and the flags: editing a header the sources include names a
    new library, so a stale one is never reused."""
    from fsvlm_tpu_torch.ops.kernels import build

    assert {"blockwise_attn_fwd", "blockwise_attn_bwd"} <= set(build.SOURCES)
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// v1\n")
    monkeypatch.setattr(build, "KERNEL_DIR", str(tmp_path))
    monkeypatch.setattr(build, "SOURCES", {"k": "k.cu"})
    first = build.library_path("k")
    assert build.library_path("k") == first
    (tmp_path / "h.cuh").write_text("// v2\n")
    second = build.library_path("k")
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n// edited\n')
    assert len({first, second, build.library_path("k")}) == 3
