"""The port's hand-written CUDA kernels on the card, against their plain
versions.  Every test here is marked ``cuda`` and skips without a card: a
CUDA kernel has no CPU mode.

This file imports neither JAX nor the JAX package, so it runs on a machine
that has only PyTorch; skip the suite's JAX-loading conftest there:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py -q

Tolerances are chip_smoke.py's.  Forward (max abs error): fp32 1e-4 for O
and LSE; bf16 2e-2 for O (one output ulp near 2-4 is 0.016) and 1e-2 for
LSE.  Backward (max abs error of each of dQ, dK and dV over the largest
abs value of the plain version's three): fp32 1e-5; bf16 1e-2 (an output
ulp is 2^-8 relative).  One denominator for the three, because a gradient
can be zero up to rounding (at L = 1, dQ = dK = 0 exactly and dV = dO).
"""

import numpy as np
import pytest
import torch

from fsvlm_tpu_torch.ops import attention, flash_attention
from fsvlm_tpu_torch.ops.layers import linear

pytestmark = pytest.mark.cuda

TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 1e-2)}
TOL_BWD = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernels have no CPU mode")
    return torch.device("cuda")


def _qkv_views(B, H, L, dtype, seed, d=64):
    """q, k, v as mha makes them: strided (B, H, L, d) views of one
    (B, L, 3*H*d) projection."""
    qkv = np.random.RandomState(seed).randn(B, L, 3 * H * d).astype(np.float32)
    qkv = torch.from_numpy(qkv).cuda().to(dtype)
    return [t.view(B, L, H, d).transpose(1, 2) for t in qkv.split(H * d, dim=-1)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("B,H,L,causal", [
    (3, 12, 201, False), (4, 8, 16, True), (4, 8, 24, True), (2, 8, 77, True),
    (2, 4, 513, True), (3, 2, 1, False), (2, 2, 1024, True), (2, 2, 130, False),
])
def test_flash_attn_fwd_matches_plain(card, dtype, B, H, L, causal):
    q, k, v = _qkv_views(B, H, L, dtype, seed=L + H)
    mask = attention.causal_mask(L, device=card) if causal else None
    o, lse = flash_attention.attention_fwd(q, k, v, mask)
    o_ref, lse_ref = flash_attention.attention_fwd(q, k, v, mask, impl="plain")
    torch.cuda.synchronize()
    assert o.dtype == dtype and o.shape == (B, H, L, 64)
    assert lse.dtype == torch.float32 and lse.shape == (B, H, L)
    tol_o, tol_lse = TOL[dtype]
    assert (o.float() - o_ref.float()).abs().max().item() <= tol_o
    assert (lse - lse_ref).abs().max().item() <= tol_lse


def test_flash_attn_fwd_takes_contiguous_inputs_and_a_general_mask(card):
    q, k, v = [t.contiguous() for t in _qkv_views(2, 4, 40, torch.float32, seed=7)]
    mask = torch.from_numpy(np.random.RandomState(8).randn(40, 40).astype(np.float32)).cuda()
    mask[3] = float("-inf")  # a row with every key masked: O = 0, as in the plain version
    o, lse = flash_attention.attention_fwd(q, k, v, mask)
    o_ref, lse_ref = flash_attention.attention_fwd(q, k, v, mask, impl="plain")
    assert torch.isfinite(o).all()
    assert (o - o_ref).abs().max().item() <= 1e-4
    assert (lse - lse_ref).abs().max().item() <= 1e-4


def test_flash_attn_fwd_counts_launches_and_rejects_what_it_does_not_take(card):
    fa = flash_attention
    q, k, v = _qkv_views(2, 2, 16, torch.bfloat16, seed=1)
    before = fa.LAUNCHES[fa.KERNEL]
    fa.attention_fwd(q, k, v)
    assert fa.LAUNCHES[fa.KERNEL] == before + 1
    fa.attention_fwd(q, k, v, impl="plain")
    assert fa.LAUNCHES[fa.KERNEL] == before + 1
    bad = [
        ((q.half(), k.half(), v.half()), {}, TypeError),  # fp16
        ((q, k.float(), v), {}, TypeError),  # mixed dtypes
        ((q[..., :32], k[..., :32], v[..., :32]), {}, ValueError),  # head dim 32
        ((q, k[:, :, :8], v[:, :, :8]), {}, ValueError),  # ragged L
        ((q.transpose(2, 3).contiguous().transpose(2, 3), k, v), {}, ValueError),  # d stride
        ((q, k, v), {"mask": torch.zeros(8, 8, device=card)}, ValueError),  # mask shape
        ((q, k, v), {"mask": torch.zeros(16, 16)}, ValueError),  # mask on the CPU
        ((q, k.cpu(), v), {}, ValueError),  # mixed devices
    ]
    for args, kw, err in bad:
        with pytest.raises(err):
            fa.attention_fwd(*args, **kw)
    assert fa.LAUNCHES[fa.KERNEL] == before + 1


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "nomask"])
def test_mha_through_the_kernel_matches_the_plain_path(card, causal):
    rng = np.random.RandomState(2)
    B, L, D, H = 3, 37, 256, 4
    x = torch.from_numpy(rng.randn(B, L, D).astype(np.float32)).cuda()
    w = {n: torch.from_numpy((rng.randn(*s) * s[0] ** -0.5).astype(np.float32)).cuda()
         for n, s in (("w_qkv", (D, 3 * D)), ("w_out", (D, D)))}
    b_qkv = torch.zeros(3 * D, device=card)
    b_out = torch.zeros(D, device=card)
    mask = attention.causal_mask(L, device=card) if causal else None
    out = attention.mha(x, w["w_qkv"], b_qkv, w["w_out"], b_out, H, mask=mask)
    ref = attention.mha(x, w["w_qkv"], b_qkv, w["w_out"], b_out, H, mask=mask, impl="plain")
    assert (out - ref).abs().max().item() <= 1e-4
    # the kernel writes O as (B, L, H, d) so that merging the heads is a view
    o, _ = flash_attention.attention_fwd(
        *[t.view(B, L, H, 64).transpose(1, 2)
          for t in linear(x, w["w_qkv"], b_qkv).split(D, dim=-1)], mask)
    assert o.transpose(1, 2).is_contiguous()


# ------------------------------------------------------------------ backward
def _rel_errs(got, want):
    """max |got_i - want_i| over the largest |want_j|, for each gradient i."""
    scale = max(w.float().abs().max().item() for w in want)
    return [(g.float() - w.float()).abs().max().item() / scale for g, w in zip(got, want)]


def _assert_p_and_ds_kept_in_fp32(got, plain, exact):
    """A bf16 backward's gradients ``got`` against an fp32 plain backward on
    the same bf16-valued inputs (``exact``), beside the bf16 plain version
    (``plain``), which keeps P and dS in fp32 and rounds only its outputs.
    Rounding P or dS to bf16 once adds an error about as large as the
    outputs' own rounding, so about sqrt(2) times the plain version's
    distance to ``exact`` in the Frobenius norm; their hi + lo parts leave
    it where the plain version's is.  So each
    gradient's distance is at most 1.1 times the plain version's, and its
    max abs error at most the plain version's plus one output ulp, 2^-8 of
    the largest gradient.  Prints both readings."""
    scale = max(e.abs().max().item() for e in exact)
    for name, g, p, e in zip(("dq", "dk", "dv"), got, plain, exact):
        g, p = g.float(), p.float()
        err_kernel, err_plain = (g - e).abs().max().item(), (p - e).abs().max().item()
        ratio = (g - e).norm().item() / (p - e).norm().item()
        print(f"{name}: norm ratio {ratio:.4f}, max|err| {err_kernel / scale:.3e} "
              f"(plain {err_plain / scale:.3e}) of the largest gradient")
        assert ratio <= 1.1, (name, ratio)
        assert err_kernel <= err_plain + 2 ** -8 * scale, (name, err_kernel, err_plain, scale)


def _blhd_view(B, H, L, dtype, seed, d=64):
    """A (B, H, L, d) view of (B, L, H, d) memory: the layout in which dO
    reaches the attention from mha's merge of the heads."""
    g = np.random.RandomState(seed).randn(B, L, H, d).astype(np.float32)
    return torch.from_numpy(g).cuda().to(dtype).transpose(1, 2)


# lengths at the edges of the bf16 tensor-core backward's layouts (a whole
# (b*h) per warp at L <= 16 and <= 32, then CTAs of 64 (dK/dV) and 128 (dQ)
# own rows over 64-row tiles of the other side) and the main paths' lengths
_FLASH_BWD_LENGTHS = (1, 8, 15, 16, 17, 24, 31, 32, 33, 63, 64, 65, 77, 127, 128, 129, 201)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("B,H,L,causal", [
    (48, 12, 201, False), (100, 8, 16, True),  # the train step's vision and text shapes
    (3, 2, 1, False), (4, 8, 8, True), (4, 8, 24, True), (2, 8, 77, True),
    (2, 4, 513, True), (2, 2, 1024, True),
    # B*H = 6, not a multiple of a packed CTA's 4 heads, at every edge length
    *((2, 3, L, causal) for L in _FLASH_BWD_LENGTHS for causal in (True, False)),
])
def test_flash_attn_bwd_matches_plain(card, dtype, B, H, L, causal):
    """One launch of each backward kernel and of no other, outputs written
    (B, L, H, d), against the plain backward."""
    fa = flash_attention
    q, k, v = _qkv_views(B, H, L, dtype, seed=L + H)
    do = _blhd_view(B, H, L, dtype, seed=L + H + 1)
    mask = attention.causal_mask(L, device=card) if causal else None
    o, lse = fa.attention_fwd(q, k, v, mask)
    before = dict(fa.LAUNCHES)
    dq, dk, dv = fa._kernel_bwd(q, k, v, o, lse, do, mask)
    assert {n: fa.LAUNCHES[n] - before[n] for n in fa.LAUNCHES} == {
        n: int(n in (fa.KERNEL_DKV, fa.KERNEL_DQ)) for n in fa.LAUNCHES}
    ref = fa.reference_attention_bwd(q, k, v, o, lse, do, mask)
    torch.cuda.synchronize()
    for name, got in zip(("dq", "dk", "dv"), (dq, dk, dv)):
        assert got.dtype == dtype and got.shape == (B, H, L, 64), name
        assert got.transpose(1, 2).is_contiguous(), name  # written (B, L, H, d)
        assert torch.isfinite(got).all(), name
    errs = _rel_errs((dq, dk, dv), ref)
    assert max(errs) <= TOL_BWD[dtype], errs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_attention_grads_through_the_kernels_match_the_plain_path(card, dtype):
    """autograd through attention_fwd: the kernels' backward against the
    plain backward, on strided q, k, v views and a (B, L, H, d) dO."""
    B, H, L = 4, 4, 150
    q, k, v = [t.detach().requires_grad_() for t in _qkv_views(B, H, L, dtype, seed=4)]
    do = _blhd_view(B, H, L, dtype, seed=5)
    mask = attention.causal_mask(L, device=card)
    grads = {}
    for impl in (None, "plain"):
        o, _ = flash_attention.attention_fwd(q, k, v, mask, impl=impl)
        grads[impl] = torch.autograd.grad(o, (q, k, v), do)
    assert max(_rel_errs(grads[None], grads["plain"])) <= TOL_BWD[dtype]


def test_flash_attn_bwd_general_mask_and_a_fully_masked_row(card):
    q, k, v = [t.contiguous() for t in _qkv_views(2, 4, 40, torch.float32, seed=9)]
    do = torch.from_numpy(np.random.RandomState(10).randn(2, 4, 40, 64).astype(np.float32)).cuda()
    mask = torch.from_numpy(np.random.RandomState(11).randn(40, 40).astype(np.float32)).cuda()
    mask[3] = float("-inf")  # every key masked: LSE ~ -1e30, zero gradients, no NaN
    mask[:, 5] = float("-inf")  # one key masked for every query: zero dK, dV rows
    o, lse = flash_attention.attention_fwd(q, k, v, mask)
    grads = flash_attention._kernel_bwd(q, k, v, o, lse, do, mask)
    ref = flash_attention.reference_attention_bwd(q, k, v, o, lse, do, mask)
    assert all(torch.isfinite(g).all() for g in grads)
    assert max(_rel_errs(grads, ref)) <= TOL_BWD[torch.float32]
    dq, dk, dv = grads
    assert dq[:, :, 3].abs().max().item() == 0.0
    assert dk[:, :, 5].abs().max().item() == 0.0 and dv[:, :, 5].abs().max().item() == 0.0


def test_flash_attn_bwd_counts_launches_and_rejects_what_it_does_not_take(card):
    fa = flash_attention
    q, k, v = _qkv_views(2, 2, 16, torch.bfloat16, seed=1)
    o, lse = fa.attention_fwd(q, k, v)
    do = torch.ones_like(o)
    delta = fa.attention_delta(o, do)
    counts = (fa.LAUNCHES[fa.KERNEL_DKV], fa.LAUNCHES[fa.KERNEL_DQ])
    op = torch.ops.fsvlm.flash_attn_bwd_d64
    bad = [
        (q, k, v, do.float(), lse, delta, None),  # dO dtype
        (q, k, v, do[:, :, :8], lse, delta, None),  # dO shape
        (q, k, v, do, lse[:, :, :8].contiguous(), delta, None),  # LSE shape
        (q, k, v, do, lse, delta.bfloat16(), None),  # delta dtype
        (q, k, v, do, lse.transpose(1, 2).contiguous().transpose(1, 2), delta, None),  # LSE layout
        (q, k, v, do, lse, delta, torch.zeros(8, 8, device=card)),  # mask shape
        (q[..., :32], k[..., :32], v[..., :32], do[..., :32], lse, delta, None),  # head dim 32
    ]
    for args in bad:
        with pytest.raises((ValueError, TypeError)):
            op(*args)
    assert (fa.LAUNCHES[fa.KERNEL_DKV], fa.LAUNCHES[fa.KERNEL_DQ]) == counts
    # the plain path launches nothing
    qg = q.detach().requires_grad_()
    o2, _ = fa.attention_fwd(qg, k, v, impl="plain")
    o2.float().sum().backward()
    assert (fa.LAUNCHES[fa.KERNEL_DKV], fa.LAUNCHES[fa.KERNEL_DQ]) == counts
    o3, _ = fa.attention_fwd(qg, k, v)
    o3.float().sum().backward()
    assert (fa.LAUNCHES[fa.KERNEL_DKV], fa.LAUNCHES[fa.KERNEL_DQ]) == (counts[0] + 1, counts[1] + 1)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "nomask"])
def test_mha_backward_through_the_kernels_matches_the_plain_path(card, causal):
    rng = np.random.RandomState(3)
    B, L, D, H = 3, 37, 256, 4
    x0 = torch.from_numpy(rng.randn(B, L, D).astype(np.float32)).cuda()
    w = {n: torch.from_numpy((rng.randn(*s) * s[0] ** -0.5).astype(np.float32)).cuda()
         for n, s in (("w_qkv", (D, 3 * D)), ("w_out", (D, D)))}
    b_qkv = torch.zeros(3 * D, device=card)
    b_out = torch.zeros(D, device=card)
    g = torch.from_numpy(rng.randn(B, L, D).astype(np.float32)).cuda()
    mask = attention.causal_mask(L, device=card) if causal else None
    grads = {}
    for impl in (None, "plain"):
        x = x0.clone().requires_grad_()
        out = attention.mha(x, w["w_qkv"], b_qkv, w["w_out"], b_out, H, mask=mask, impl=impl)
        grads[impl], = torch.autograd.grad(out, x, g)
    assert max(_rel_errs([grads[None]], [grads["plain"]])) <= 1e-5


# ---------------------- the bf16 tensor-core flash backwards #7/#8 and #4/#5
# mma_attn.cuh's dK/dV and dQ kernels from the LSE: behind the d = 64 entry
# ("packed", #7/#8) and behind the blockwise one (#4/#5) at its
# instantiations D = 32, 64 and 128
_BWD_ENTRIES = [("packed", 64), ("blockwise", 32), ("blockwise", 64), ("blockwise", 128)]


def _bwd_fns(entry):
    """(kernel forward, kernel backward with its delta pre-pass, plain
    backward) of the d = 64 family ("packed") or the blockwise one."""
    fa = flash_attention
    if entry == "packed":
        return fa.attention_fwd, fa._kernel_bwd, fa.reference_attention_bwd
    return torch.ops.fsvlm.blockwise_attn_fwd, fa._bw_kernel_bwd, fa.reference_blockwise_bwd


def _flash_bwd_case(q, k, v, do, mask, entry):
    """The entry's backward through the kernels and through the plain
    version on the kernel forward's O and LSE: (kernel grads, plain grads,
    whether it launched each of its two backward kernels once and no other
    kernel)."""
    fa = flash_attention
    fwd, bwd, plain_bwd = _bwd_fns(entry)
    o, lse = fwd(q, k, v, mask)
    before = dict(fa.LAUNCHES)
    grads = bwd(q, k, v, o, lse, do, mask)
    own = (fa.KERNEL_DKV, fa.KERNEL_DQ) if entry == "packed" else (fa.BW_KERNEL_DKV, fa.BW_KERNEL_DQ)
    launched_own = all(fa.LAUNCHES[n] - before[n] == int(n in own) for n in fa.LAUNCHES)
    ref = plain_bwd(q, k, v, o, lse, do, mask)
    torch.cuda.synchronize()
    return grads, ref, launched_own


@pytest.mark.parametrize("L", [16, 24, 77, 201])
@pytest.mark.parametrize("layout", ["qkv", "blhd", "contiguous", "unaligned"])
@pytest.mark.parametrize("entry,d", _BWD_ENTRIES)
def test_flash_bwd_bf16_strided_contiguous_and_unaligned_layouts(card, entry, d, layout, L):
    """#7/#8 and #4/#5 in bf16 on mha's strided views of one QKV buffer, on
    (B, L, H, d) views, on contiguous (B, H, L, d) tensors (all of which take
    the 16-byte cp.async copies) and on views whose bases and row strides are
    not 16-byte aligned (rows of d + 1 elements, the first dropped), which
    the kernels copy element by element; one launch of each of the entry's
    backward kernels, against the plain backward."""
    B, H = 3, 5
    if layout == "qkv":
        q, k, v = _qkv_views(B, H, L, torch.bfloat16, seed=L + 80, d=d)
        do = _blhd_view(B, H, L, torch.bfloat16, seed=L + 81, d=d)
    elif layout == "unaligned":
        q, k, v, do = [t.contiguous()[..., 1:] for t in
                       _blhd_tensors(B, H, L, d + 1, torch.bfloat16, seed=L + 80, n=4)]
    else:
        q, k, v, do = _blhd_tensors(B, H, L, d, torch.bfloat16, seed=L + 80, n=4)
        if layout == "contiguous":
            q, k, v, do = [t.contiguous() for t in (q, k, v, do)]
    mask = attention.causal_mask(L, device=card)
    grads, ref, launched_own = _flash_bwd_case(q, k, v, do, mask, entry)
    assert launched_own
    assert all(torch.isfinite(g).all() for g in grads)
    assert max(_rel_errs(grads, ref)) <= TOL_BWD[torch.bfloat16]


@pytest.mark.parametrize("L", [24, 70, 201])
@pytest.mark.parametrize("entry,d", _BWD_ENTRIES)
def test_flash_bwd_bf16_fully_masked_rows(card, entry, d, L):
    """#7/#8 and #4/#5 in bf16, a general mask with rows whose every key is
    -inf and rows whose every key is a finite -1e30 (one of each in the
    first and in the last query tile).  The forward writes LSE = -1e30 for
    both, as the plain version does.  A -inf row gets P = 0: dQ = 0 there.
    A -1e30 row gets P = exp(-1e30 - (-1e30)) = 1 on every key in the plain
    version, and so in the kernels, whose scores and LSE round alike in log2
    units.  No NaN, and the kernels within tolerance of the plain backward."""
    q, k, v = _qkv_views(2, 4, L, torch.bfloat16, seed=L + 90, d=d)
    do = _blhd_view(2, 4, L, torch.bfloat16, seed=L + 91, d=d)
    mask = torch.from_numpy(np.random.RandomState(L + 92).randn(L, L).astype(np.float32)).cuda()
    inf_rows, fin_rows = [2, L - 3], [5, L - 1]
    mask[inf_rows] = float("-inf")
    mask[fin_rows] = -1e30
    (_, lse), (_, lse_ref), _ = _flash_fwd(entry, q, k, v, mask)
    for r in inf_rows + fin_rows:
        assert torch.equal(lse[:, :, r], lse_ref[:, :, r])
    grads, ref, launched_own = _flash_bwd_case(q, k, v, do, mask, entry)
    assert launched_own
    assert all(torch.isfinite(g).all() for g in grads + ref)
    assert max(_rel_errs(grads, ref)) <= TOL_BWD[torch.bfloat16]
    for r in inf_rows:
        assert grads[0][:, :, r].abs().max().item() == 0.0
    for r in fin_rows:  # P = 1 on every key: a gradient of the same order as the plain one
        assert grads[0][:, :, r].abs().max().item() > 0.0


@pytest.mark.parametrize("B,H,L,causal", [(4, None, 201, False), (10, 8, 16, True),
                                          (6, 8, 24, True), (4, 4, 77, True)])
@pytest.mark.parametrize("entry,d", _BWD_ENTRIES)
def test_flash_bwd_bf16_keeps_p_and_ds_in_fp32(card, entry, d, B, H, L, causal):
    """#7/#8 and #4/#5 in bf16 feed P and dS to the tensor cores as bf16
    hi + lo parts, as the TPU's fp32 operands (see
    _assert_p_and_ds_kept_in_fp32); the vision shape at H d = 768, as in
    CLIP."""
    H = H or 768 // d
    q, k, v = _qkv_views(B, H, L, torch.bfloat16, seed=L + 33, d=d)
    do = _blhd_view(B, H, L, torch.bfloat16, seed=L + 34, d=d)
    mask = attention.causal_mask(L, device=card) if causal else None
    fwd, bwd, plain_bwd = _bwd_fns(entry)
    o, lse = fwd(q, k, v, mask)
    got = bwd(q, k, v, o, lse, do, mask)
    plain = plain_bwd(q, k, v, o, lse, do, mask)
    exact = plain_bwd(*(t.float() for t in (q, k, v, o)), lse, do.float(), mask)
    _assert_p_and_ds_kept_in_fp32(got, plain, exact)


@pytest.mark.parametrize("L", [16, 201])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_blockwise_bwd_launches_the_tensor_core_kernels_in_bf16(card, dtype, d, L):
    """The device kernels that torch.ops.fsvlm.blockwise_attn_bwd launches
    (torch.profiler): in bf16 exactly mma_attn.cuh's dK/dV and dQ kernels
    at instantiation d, reading the LSE (kLse = true; packed at L <= 32,
    tiled past it), and no FMA tile; in fp32 the FMA tiles."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fa = flash_attention
    q, k, v = _qkv_views(2, 4, L, dtype, seed=L + d + 70, d=d)
    do = _blhd_view(2, 4, L, dtype, seed=L + d + 71, d=d)
    o, lse = torch.ops.fsvlm.blockwise_attn_fwd(q, k, v, None)
    delta = fa.attention_delta(o, do)
    # a warm-up launch first: in a cold process (one that also compiled the
    # kernels) the profiler's first CUDA trace can come back without events
    torch.ops.fsvlm.blockwise_attn_bwd(q, k, v, do, lse, delta, None)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.ops.fsvlm.blockwise_attn_bwd(q, k, v, do, lse, delta, None)
        torch.cuda.synchronize()
    names = sorted({e.key for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA and "attn" in e.key})
    if dtype == torch.bfloat16:
        layout, rows = ("tiled", "") if L > 32 else ("packed", "16, ")
        want = [f"mma_attn::{kind}_{layout}_kernel<{d}, {rows}true" for kind in ("dkv", "dq")]
    else:
        want = [f"blockwise::attn_bwd_{kind}_kernel<float, {d}, false>" for kind in ("dkv", "dq")]
    assert len(names) == 2, names
    for frag in want:
        assert sum(frag in n for n in names) == 1, (frag, names)


# ---------------------------------------------------- blockwise kernels #3-#5
_BW_SHAPES = [  # (B, H, L, causal): the IVLP step's vision and text shapes, edges of L
    (6, 12, 201, False), (10, 8, 16, True), (3, 2, 1, False), (4, 8, 8, True),
    (2, 8, 77, True), (2, 4, 300, False), (2, 4, 513, True),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("B,H,L,causal", _BW_SHAPES)
@pytest.mark.parametrize("d", [32, 64, 128, 80])
def test_blockwise_fwd_and_bwd_match_plain(card, d, B, H, L, causal, dtype):
    """Kernels #3-#5 on mha's strided views and a (B, L, H, d) dO, against
    the plain versions on the same inputs; outputs written (B, L, H, d)."""
    fa = flash_attention
    q, k, v = _qkv_views(B, H, L, dtype, seed=L + d, d=d)
    do = _blhd_view(B, H, L, dtype, seed=L + d + 1, d=d)
    mask = attention.causal_mask(L, device=card) if causal else None
    before = dict(fa.LAUNCHES)
    o, lse = torch.ops.fsvlm.blockwise_attn_fwd(q, k, v, mask)
    grads = fa._bw_kernel_bwd(q, k, v, o, lse, do, mask)
    o_ref, lse_ref = fa.reference_blockwise_fwd(q, k, v, mask)
    ref = fa.reference_blockwise_bwd(q, k, v, o, lse, do, mask)
    torch.cuda.synchronize()
    assert {n: fa.LAUNCHES[n] - before[n] for n in fa.LAUNCHES} == {
        n: int(n.startswith("blockwise")) for n in fa.LAUNCHES}
    tol_o, tol_lse = TOL[dtype]
    assert o.shape == (B, H, L, d) and o.transpose(1, 2).is_contiguous()
    assert (o.float() - o_ref.float()).abs().max().item() <= tol_o
    assert (lse - lse_ref).abs().max().item() <= tol_lse
    for name, got in zip(("dq", "dk", "dv"), grads):
        assert got.dtype == dtype and got.shape == (B, H, L, d), name
        assert got.transpose(1, 2).is_contiguous() and torch.isfinite(got).all(), name
    assert max(_rel_errs(grads, ref)) <= TOL_BWD[dtype]


@pytest.mark.parametrize("d", [32, 64, 128])
def test_blockwise_general_mask_and_fully_masked_rows(card, d):
    """A row with every key masked: O = 0 and zero gradients, no NaN; a key
    masked for every query: zero dK and dV rows."""
    fa = flash_attention
    q, k, v = _qkv_views(2, 4, 70, torch.float32, seed=9, d=d)
    do = _blhd_view(2, 4, 70, torch.float32, seed=10, d=d)
    mask = torch.from_numpy(np.random.RandomState(11).randn(70, 70).astype(np.float32)).cuda()
    mask[3] = float("-inf")
    mask[66] = float("-inf")  # in the second query tile
    mask[:, 5] = float("-inf")
    qkv = [t.detach().requires_grad_() for t in (q, k, v)]
    o = fa.blockwise_attention(*qkv, mask)
    grads = torch.autograd.grad(o, qkv, do)
    o_ref, lse_ref = fa.reference_blockwise_fwd(q, k, v, mask)
    ref = fa.reference_blockwise_bwd(q, k, v, o_ref, lse_ref, do, mask)
    assert torch.isfinite(o).all() and all(torch.isfinite(g).all() for g in grads)
    assert (o - o_ref).abs().max().item() <= TOL[torch.float32][0]
    assert max(_rel_errs(grads, ref)) <= TOL_BWD[torch.float32]
    dq, dk, dv = grads
    for row in (3, 66):
        assert o[:, :, row].abs().max().item() == 0.0 and dq[:, :, row].abs().max().item() == 0.0
    assert dk[:, :, 5].abs().max().item() == 0.0 and dv[:, :, 5].abs().max().item() == 0.0


def test_blockwise_rejects_what_it_does_not_take(card):
    fa = flash_attention
    q, k, v = _qkv_views(2, 2, 16, torch.bfloat16, seed=1, d=32)
    before = dict(fa.LAUNCHES)
    bad = [
        ((q.half(), k.half(), v.half(), None), TypeError),  # fp16
        ((q, k.float(), v, None), TypeError),  # mixed dtypes
        ((q, k[:, :, :8], v[:, :, :8], None), ValueError),  # ragged L
        ((q, k, v, torch.zeros(8, 8, device=card)), ValueError),  # mask shape
        ((q, k, v, torch.zeros(16, 16, dtype=torch.bfloat16, device=card)), ValueError),
        ((q, k.cpu(), v, None), ValueError),  # mixed devices
    ]
    for args, err in bad:
        with pytest.raises(err):
            torch.ops.fsvlm.blockwise_attn_fwd(*args)
    big = torch.zeros(1, 2, 8, 136, device=card)
    with pytest.raises(ValueError, match="B6"):
        fa.blockwise_attention(big, big, big)
    assert fa.LAUNCHES == before


@pytest.mark.parametrize("force,launched", [(None, "flash_attn"), ("1", "blockwise")],
                         ids=["default", "force_pallas"])
def test_mha_launches_the_routed_family(card, force, launched, monkeypatch):
    """mha at head dim 64: the d = 64 kernels by default, the blockwise ones
    (and no other) under FSVLM_FORCE_PALLAS=1; each agrees with the plain
    path, forward and backward."""
    fa = flash_attention
    if force is None:
        monkeypatch.delenv("FSVLM_FORCE_PALLAS", raising=False)
    else:
        monkeypatch.setenv("FSVLM_FORCE_PALLAS", force)
    rng = np.random.RandomState(3)
    B, L, D, H = 3, 37, 256, 4
    x0 = torch.from_numpy(rng.randn(B, L, D).astype(np.float32)).cuda()
    w = {n: torch.from_numpy((rng.randn(*s) * s[0] ** -0.5).astype(np.float32)).cuda()
         for n, s in (("w_qkv", (D, 3 * D)), ("w_out", (D, D)))}
    b_qkv, b_out = torch.zeros(3 * D, device=card), torch.zeros(D, device=card)
    g = torch.from_numpy(rng.randn(B, L, D).astype(np.float32)).cuda()
    mask = attention.causal_mask(L, device=card)
    outs = {}
    for impl in (None, "plain"):
        before = dict(fa.LAUNCHES)
        x = x0.clone().requires_grad_()
        out = attention.mha(x, w["w_qkv"], b_qkv, w["w_out"], b_out, H, mask=mask, impl=impl)
        outs[impl] = (out.detach(), *torch.autograd.grad(out, x, g))
        delta = {n: fa.LAUNCHES[n] - before[n] for n in fa.LAUNCHES}
        assert delta == {n: int(impl is None and n.startswith(launched)) for n in fa.LAUNCHES}
    assert (outs[None][0] - outs["plain"][0]).abs().max().item() <= 1e-4
    assert max(_rel_errs([outs[None][1]], [outs["plain"][1]])) <= 1e-5


# ------------------------------ the bf16 tensor-core flash forward of #6 and #3
# one kernel (mma_flash_fwd.cuh) behind both entries: lengths at the edges of
# its layouts (a whole (b*h) per warp at L <= 16 and <= 32, 64-row CTAs and
# 64-key tiles past 32, one key tile up to 64) and the main paths' lengths
_FLASH_LENGTHS = (1, 8, 15, 16, 17, 24, 31, 32, 33, 63, 64, 65, 77, 197, 201, 513, 1024)
_FLASH_ENTRIES = [("packed", 64), ("blockwise", 32), ("blockwise", 64), ("blockwise", 80),
                  ("blockwise", 128)]


def _flash_fwd(entry, q, k, v, mask):
    """Forward entry "packed" (#6, attention_fwd) or "blockwise" (#3, its
    operator) on the kernel and on the plain version: ((O, LSE), (O, LSE)
    plain, the kernel's launch name)."""
    fa = flash_attention
    if entry == "packed":
        return fa.attention_fwd(q, k, v, mask), fa.attention_fwd(q, k, v, mask, impl="plain"), fa.KERNEL
    return (torch.ops.fsvlm.blockwise_attn_fwd(q, k, v, mask),
            fa.reference_blockwise_fwd(q, k, v, mask), fa.BW_KERNEL)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "nomask"])
@pytest.mark.parametrize("L", _FLASH_LENGTHS)
@pytest.mark.parametrize("entry,d", _FLASH_ENTRIES)
def test_flash_fwd_bf16_tensor_cores_match_plain(card, entry, d, L, causal):
    """#6 and #3 in bf16 on mha's strided views, B*H = 6 (not a multiple of
    a packed CTA's 4 heads), against the plain version, which walks the same
    64-key tiles: one launch of the entry's kernel, O written (B, L, H, d),
    LSE (B, H, L) contiguous."""
    fa = flash_attention
    B, H = 2, 3
    q, k, v = _qkv_views(B, H, L, torch.bfloat16, seed=L + d + 40, d=d)
    mask = attention.causal_mask(L, device=card) if causal else None
    before = dict(fa.LAUNCHES)
    (o, lse), (o_ref, lse_ref), name = _flash_fwd(entry, q, k, v, mask)
    torch.cuda.synchronize()
    assert {n: fa.LAUNCHES[n] - before[n] for n in fa.LAUNCHES} == {
        n: int(n == name) for n in fa.LAUNCHES}
    assert o.dtype == torch.bfloat16 and o.shape == (B, H, L, d) and o.transpose(1, 2).is_contiguous()
    assert lse.dtype == torch.float32 and lse.shape == (B, H, L) and lse.is_contiguous()
    tol_o, tol_lse = TOL[torch.bfloat16]
    assert (o.float() - o_ref.float()).abs().max().item() <= tol_o
    assert (lse - lse_ref).abs().max().item() <= tol_lse


@pytest.mark.parametrize("L", [16, 24, 77, 201])
@pytest.mark.parametrize("entry,layout,d", [("packed", "blhd", 64), ("packed", "unaligned", 64),
                                            ("blockwise", "blhd", 128),
                                            ("blockwise", "unaligned", 36)])
def test_flash_fwd_bf16_strided_and_unaligned_layouts(card, entry, layout, d, L):
    """#6 and #3 in bf16 on (B, H, L, d) views of (B, L, H, d) memory, and on
    views whose bases and row strides are not 16-byte aligned (rows of
    d + 1 elements, the first dropped), which the kernel copies element by
    element instead of by 16-byte cp.async; against the plain version."""
    B, H = 3, 5
    if layout == "blhd":
        q, k, v = _blhd_tensors(B, H, L, d, torch.bfloat16, seed=L + d + 50, n=3)
    else:
        q, k, v = [t.contiguous()[..., 1:] for t in
                   _blhd_tensors(B, H, L, d + 1, torch.bfloat16, seed=L + d + 50, n=3)]
    mask = attention.causal_mask(L, device=card)
    (o, lse), (o_ref, lse_ref), _ = _flash_fwd(entry, q, k, v, mask)
    torch.cuda.synchronize()
    tol_o, tol_lse = TOL[torch.bfloat16]
    assert (o.float() - o_ref.float()).abs().max().item() <= tol_o
    assert (lse - lse_ref).abs().max().item() <= tol_lse


@pytest.mark.parametrize("L", [24, 70])
@pytest.mark.parametrize("entry,d", [("packed", 64), ("blockwise", 32), ("blockwise", 128)])
def test_flash_fwd_bf16_fully_masked_rows(card, entry, d, L):
    """bf16, a general mask with rows whose every key is -inf (at L = 70 one
    in each query tile): O = 0 there and LSE equal to the plain version's
    -1e30 + log(1e-30), the rest within tolerance; the backward kernels read
    that LSE and give those rows dQ = 0, with no NaN anywhere."""
    fa = flash_attention
    q, k, v = _qkv_views(2, 4, L, torch.bfloat16, seed=L + d + 60, d=d)
    mask = torch.from_numpy(np.random.RandomState(L).randn(L, L).astype(np.float32)).cuda()
    rows = [3, L - 4]
    mask[rows] = float("-inf")
    (o, lse), (o_ref, lse_ref), _ = _flash_fwd(entry, q, k, v, mask)
    tol_o, tol_lse = TOL[torch.bfloat16]
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    assert (o.float() - o_ref.float()).abs().max().item() <= tol_o
    assert (lse - lse_ref).abs().max().item() <= tol_lse
    for r in rows:
        assert o[:, :, r].abs().max().item() == 0.0
        assert torch.equal(lse[:, :, r], lse_ref[:, :, r])
    qkv = [t.detach().requires_grad_() for t in (q, k, v)]
    out = fa.attention_fwd(*qkv, mask)[0] if entry == "packed" else fa.blockwise_attention(*qkv, mask)
    grads = torch.autograd.grad(out, qkv, torch.ones_like(out))
    assert all(torch.isfinite(g).all() for g in grads)
    for r in rows:
        assert grads[0][:, :, r].abs().max().item() == 0.0


# ----------------------------------------------- whole-sequence kernels #1-#2
_FUSED_SHAPES = [  # (B, H, L, causal): the CoOp/CoCoOp vision and text shapes, edges of L
    (6, 12, 197, False), (10, 8, 24, True), (10, 8, 16, True), (3, 2, 1, False), (4, 8, 8, True),
    (2, 8, 77, True), (2, 4, 300, False), (2, 4, 513, True), (2, 2, 1024, True),
    # the bf16 kernels' edges: a whole (b*h) per warp at L <= 16 and <= 32, 64-row tiles past
    # 32, S in one tile up to 64; and B*H not a multiple of a packed CTA's 4 heads
    (2, 2, 15, True), (2, 2, 17, False), (2, 2, 31, True), (2, 2, 32, False), (2, 2, 33, True),
    (2, 2, 63, False), (2, 2, 64, True), (2, 2, 65, False), (3, 1, 16, True), (5, 1, 24, True),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("B,H,L,causal", _FUSED_SHAPES)
@pytest.mark.parametrize("d", [32, 64, 128, 80])
def test_fused_fwd_and_bwd_match_plain(card, d, B, H, L, causal, dtype):
    """Kernels #1-#2 on mha's strided views and a (B, L, H, d) dO, against
    the plain versions on the same inputs; one launch of the forward and of
    each backward kernel, outputs written (B, L, H, d)."""
    fa = flash_attention
    q, k, v = _qkv_views(B, H, L, dtype, seed=L + d + 7, d=d)
    do = _blhd_view(B, H, L, dtype, seed=L + d + 8, d=d)
    mask = attention.causal_mask(L, device=card) if causal else None
    before = dict(fa.LAUNCHES)
    o = torch.ops.fsvlm.fused_attn_fwd(q, k, v, mask)
    grads = torch.ops.fsvlm.fused_attn_bwd(q, k, v, do, mask)
    o_ref = fa.reference_fused_fwd(q, k, v, mask)
    ref = fa.reference_fused_bwd(q, k, v, do, mask)
    torch.cuda.synchronize()
    assert {n: fa.LAUNCHES[n] - before[n] for n in fa.LAUNCHES} == {
        n: int(n.startswith("fused_attn")) for n in fa.LAUNCHES}
    assert o.shape == (B, H, L, d) and o.dtype == dtype and o.transpose(1, 2).is_contiguous()
    assert (o.float() - o_ref.float()).abs().max().item() <= TOL[dtype][0]
    for name, got in zip(("dq", "dk", "dv"), grads):
        assert got.dtype == dtype and got.shape == (B, H, L, d), name
        assert got.transpose(1, 2).is_contiguous() and torch.isfinite(got).all(), name
    assert max(_rel_errs(grads, ref)) <= TOL_BWD[dtype]


@pytest.mark.parametrize("d", [32, 64, 128])
def test_fused_general_mask_and_a_fully_masked_row(card, d):
    """A general additive mask through fused_attention's autograd against
    the plain versions; a row with every key at -inf gives NaN in the kernel
    as in the plain version (and in JAX at L a multiple of 128)."""
    fa = flash_attention
    q, k, v = _qkv_views(2, 4, 70, torch.float32, seed=19, d=d)
    do = _blhd_view(2, 4, 70, torch.float32, seed=20, d=d)
    mask = torch.from_numpy(np.random.RandomState(21).randn(70, 70).astype(np.float32)).cuda()
    mask[:, 5] = float("-inf")
    qkv = [t.detach().requires_grad_() for t in (q, k, v)]
    o = fa.fused_attention(*qkv, mask)
    grads = torch.autograd.grad(o, qkv, do)
    assert (o - fa.reference_fused_fwd(q, k, v, mask)).abs().max().item() <= TOL[torch.float32][0]
    assert max(_rel_errs(grads, fa.reference_fused_bwd(q, k, v, do, mask))) <= TOL_BWD[torch.float32]
    assert grads[1][:, :, 5].abs().max().item() == 0.0 and grads[2][:, :, 5].abs().max().item() == 0.0
    mask[3] = float("-inf")
    o = fa.fused_attention(q, k, v, mask)
    assert torch.isnan(o[:, :, 3]).all() and torch.isnan(fa.reference_fused_fwd(q, k, v, mask)[:, :, 3]).all()
    assert torch.isfinite(o[:, :, 4:]).all()


def _blhd_tensors(B, H, L, d, dtype, seed, n):
    """n (B, H, L, d) views of (B, L, H, d) memory: the layout in which the
    kernels write O and the gradients (``_blhd``), and so in which a layer
    may take them in."""
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(B, L, H, d).astype(np.float32)).cuda().to(dtype).transpose(1, 2)
            for _ in range(n)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("layout,d", [("blhd", 64), ("blhd", 128), ("unaligned", 36),
                                      ("unaligned", 100)])
@pytest.mark.parametrize("L", [16, 24, 77])
def test_fused_strided_and_unaligned_layouts(card, layout, d, L, dtype):
    """#1-#2 on (B, H, L, d) views of (B, L, H, d) memory, and on contiguous
    tensors whose row stride (d = 36, 100) is not a multiple of 8 elements,
    which the bf16 kernels copy element by element instead of by 16-byte
    cp.async; against the plain versions."""
    fa = flash_attention
    B, H = 3, 5
    if layout == "blhd":
        q, k, v, do = _blhd_tensors(B, H, L, d, dtype, seed=L + d, n=4)
    else:
        q, k, v, do = [t.contiguous() for t in _blhd_tensors(B, H, L, d, dtype, seed=L + d, n=4)]
    mask = attention.causal_mask(L, device=card)
    o = torch.ops.fsvlm.fused_attn_fwd(q, k, v, mask)
    grads = torch.ops.fsvlm.fused_attn_bwd(q, k, v, do, mask)
    torch.cuda.synchronize()
    assert (o.float() - fa.reference_fused_fwd(q, k, v, mask).float()).abs().max().item() <= TOL[dtype][0]
    assert max(_rel_errs(grads, fa.reference_fused_bwd(q, k, v, do, mask))) <= TOL_BWD[dtype]


@pytest.mark.parametrize("B,H,L,causal", [(4, 12, 197, False), (10, 8, 16, True),
                                          (6, 8, 24, True), (4, 4, 77, True)])
def test_fused_bf16_backward_keeps_p_and_ds_in_fp32(card, B, H, L, causal):
    """The bf16 backward feeds P and dS to the tensor cores as bf16 hi + lo
    parts, as the TPU's fp32 operands (see _assert_p_and_ds_kept_in_fp32)."""
    fa = flash_attention
    q, k, v = _qkv_views(B, H, L, torch.bfloat16, seed=L + 31)
    do = _blhd_view(B, H, L, torch.bfloat16, seed=L + 32)
    mask = attention.causal_mask(L, device=card) if causal else None
    got = torch.ops.fsvlm.fused_attn_bwd(q, k, v, do, mask)
    plain = fa.reference_fused_bwd(q, k, v, do, mask)
    exact = fa.reference_fused_bwd(*(t.float() for t in (q, k, v, do)), mask)
    _assert_p_and_ds_kept_in_fp32(got, plain, exact)


def test_fused_rejects_what_it_does_not_take(card, monkeypatch):
    fa = flash_attention
    q, k, v = _qkv_views(2, 2, 16, torch.bfloat16, seed=1, d=32)
    before = dict(fa.LAUNCHES)
    bad = [
        ((q.half(), k.half(), v.half(), None), TypeError),  # fp16
        ((q, k.float(), v, None), TypeError),  # mixed dtypes
        ((q, k[:, :, :8], v[:, :, :8], None), ValueError),  # ragged L
        ((q, k, v, torch.zeros(2, 1, 1, 16, device=card)), ValueError),  # a broadcast mask
        ((q, k, v, torch.zeros(16, 16, dtype=torch.bfloat16, device=card)), ValueError),
        ((q, k.cpu(), v, None), ValueError),  # mixed devices
    ]
    for args, err in bad:
        with pytest.raises(err):
            torch.ops.fsvlm.fused_attn_fwd(*args)
    big = torch.zeros(1, 2, 8, 136, device=card)
    with pytest.raises(ValueError, match="B6"):
        fa.fused_attention(big, big, big)
    monkeypatch.setenv("FSVLM_FORCE_PALLAS", "legacy")
    with pytest.raises(ValueError, match="cannot take it"):
        fa.attention_dispatch(q, k, v, torch.zeros(2, 1, 1, 16, device=card))
    assert fa.LAUNCHES == before


def test_fused_build_and_launch_errors_propagate(card, monkeypatch):
    """A wrapper never gives way to the plain version: a failed build and a
    launch that returns a CUDA error both raise, and count no launch."""
    from fsvlm_tpu_torch.ops.kernels import build

    fa = flash_attention
    q, k, v = _qkv_views(2, 2, 16, torch.float32, seed=2, d=64)
    before = dict(fa.LAUNCHES)

    def failed_build(name):
        raise RuntimeError(f"nvcc failed for {build.SOURCES[name]} (rc 1)")

    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(build, "build", failed_build)
    with pytest.raises(RuntimeError, match="nvcc failed for fused_attn_fwd.cu"):
        fa.fused_attention(q, k, v)
    monkeypatch.undo()

    real = fa._kernel_fn

    def failing_launch(library, entry):
        lib, _ = real(library, entry)
        return lib, lambda *args: 98  # cudaErrorInvalidDeviceFunction

    monkeypatch.setattr(fa, "_kernel_fn", failing_launch)
    with pytest.raises(RuntimeError, match="fused_attn_fwd launch failed"):
        fa.fused_attention(q, k, v)
    assert fa.LAUNCHES == before


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "nomask"])
def test_mha_under_legacy_launches_the_whole_sequence_kernels(card, causal, monkeypatch):
    """mha at head dim 64 under FSVLM_FORCE_PALLAS=legacy: one launch of #1
    forward and of each of #2's three kernels, no other family; it agrees
    with the plain path, forward and backward."""
    fa = flash_attention
    monkeypatch.setenv("FSVLM_FORCE_PALLAS", "legacy")
    rng = np.random.RandomState(4)
    B, L, D, H = 3, 37, 256, 4
    x0 = torch.from_numpy(rng.randn(B, L, D).astype(np.float32)).cuda()
    w = {n: torch.from_numpy((rng.randn(*s) * s[0] ** -0.5).astype(np.float32)).cuda()
         for n, s in (("w_qkv", (D, 3 * D)), ("w_out", (D, D)))}
    b_qkv, b_out = torch.zeros(3 * D, device=card), torch.zeros(D, device=card)
    g = torch.from_numpy(rng.randn(B, L, D).astype(np.float32)).cuda()
    mask = attention.causal_mask(L, device=card) if causal else None
    outs = {}
    for impl in (None, "plain"):
        before = dict(fa.LAUNCHES)
        x = x0.clone().requires_grad_()
        out = attention.mha(x, w["w_qkv"], b_qkv, w["w_out"], b_out, H, mask=mask, impl=impl)
        outs[impl] = (out.detach(), *torch.autograd.grad(out, x, g))
        delta = {n: fa.LAUNCHES[n] - before[n] for n in fa.LAUNCHES}
        assert delta == {n: int(impl is None and n.startswith("fused_attn")) for n in fa.LAUNCHES}
    assert (outs[None][0] - outs["plain"][0]).abs().max().item() <= 1e-4
    assert max(_rel_errs([outs[None][1]], [outs["plain"][1]])) <= 1e-5


# ------------------------------------------------ PLIP and the RN towers
def _tiny_clip(card, dtype=torch.bfloat16):
    """A random CLIP with d = 64 in both towers (2 layers each)."""
    from fsvlm_tpu_torch.models.clip import CLIPConfig, random_clip_params
    from fsvlm_tpu_torch.trainers.backbone import clip_from_params

    cfg = CLIPConfig(64, 32, 2, 128, 16, 77, 49408, 128, 2, 2)
    return clip_from_params(random_clip_params(cfg, seed=3), cfg, dtype, card)


@pytest.mark.parametrize("reg_type", ["grad", "svd", "spectral_norm"])
def test_plip_step_launches(card, reg_type, monkeypatch):
    """One PLIP train step in bf16: under grad the text tower, which the
    penalty differentiates twice, takes the reference attention, so only
    the image tower's forward launches (#6 once per vision layer, #7/#8
    none); under svd and spectral_norm the text tower adds its forward
    and backward (#6-#8 once per text layer)."""
    from fsvlm_tpu_torch.config import get_cfg_default
    from fsvlm_tpu_torch.trainers.plip import PLIP

    monkeypatch.delenv("FSVLM_FORCE_PALLAS", raising=False)
    fa = flash_attention
    cfg = get_cfg_default()
    cfg.INPUT.SIZE, cfg.TRAINER.PLIP.PREC, cfg.TRAINER.PLIP.REG_TYPE = (32, 32), "bf16", reg_type
    clip = _tiny_clip(card)
    t = PLIP(cfg, ["cat", "dog", "sea"], clip=clip, device=card, steps_per_epoch=1)
    rng = np.random.RandomState(0)
    batch = {"img": rng.randn(4, 32, 32, 3).astype(np.float32), "label": np.array([0, 1, 2, 1])}
    before = dict(fa.LAUNCHES)
    metrics = t.train_step(batch)
    torch.cuda.synchronize()
    got = {k: fa.LAUNCHES[k] - before[k] for k in fa.LAUNCHES}
    Lt, Lv = clip.cfg.transformer_layers, clip.cfg.vision_layers
    text = 0 if reg_type == "grad" else Lt
    assert got[fa.KERNEL] == Lv + text and got[fa.KERNEL_DKV] == got[fa.KERNEL_DQ] == text
    assert sum(got.values()) == Lv + 3 * text
    assert torch.isfinite(metrics["loss"]) and torch.isfinite(metrics["penalty"])


def test_rn50_fp32_tower_on_the_card_matches_the_cpu(card):
    """The RN50 tower in fp32 (TF32 off for the convs and matmuls) on the
    card against the same tower on the CPU, every BN perturbed: each stage
    and the features within 1e-3 of the CPU tensor's largest entry
    (cuDNN's and the CPU's convolutions sum in other orders)."""
    from fsvlm_tpu_torch.models.clip import ARCHS, encode_image, random_clip_params
    from fsvlm_tpu_torch.trainers.backbone import clip_from_params

    params = random_clip_params(ARCHS["RN50"], seed=50)
    rng = np.random.RandomState(51)
    for node in _bn_nodes(params["visual"]):
        c = node["scale"].shape[0]
        node["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        node["bias"] = rng.normal(0, 0.05, c).astype(np.float32)
        node["mean"] = rng.normal(0, 0.1, c).astype(np.float32)
        node["var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
    images = torch.from_numpy(np.random.RandomState(13).randn(2, 224, 224, 3).astype(np.float32))
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        outs = []
        for device in ("cpu", card):
            clip = clip_from_params(params, ARCHS["RN50"], torch.float32, device)
            with torch.no_grad():
                feat, stages = encode_image(clip, images.to(device), collect_stages=True)
            outs.append([t.float().cpu() for t in [feat] + stages])
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    for ref, got in zip(*outs):
        assert got.shape == ref.shape
        assert (got - ref).abs().max().item() <= 1e-3 * ref.abs().max().item()


def _bn_nodes(tree):
    if isinstance(tree, dict) and set(tree) == {"scale", "bias", "mean", "var"}:
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _bn_nodes(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _bn_nodes(v)


@pytest.mark.parametrize("name,momentum", [("adam", 0.9), ("amsgrad", 0.9), ("adamw", 0.9),
                                           ("rmsprop", 0.9), ("rmsprop", 0.0), ("radam", 0.9),
                                           ("sgd", 0.9)])
def test_optimizer_step_on_the_card_matches_the_cpu(card, name, momentum):
    """8 steps of OPTIM.NAME on the card and on the CPU from the same
    gradients (radam rectifies from its 6th step): parameters and moment
    buffers within 1e-6 of each tensor's largest magnitude, equal counts; a
    step makes no synchronizing call; a non-finite step changes nothing."""
    from fsvlm_tpu_torch.config import get_cfg_base
    from fsvlm_tpu_torch.engine.optim import build_optimizer

    cfg = get_cfg_base()
    cfg.merge_from_list(["OPTIM.NAME", name, "OPTIM.MOMENTUM", momentum, "OPTIM.LR", 0.01,
                         "OPTIM.MAX_EPOCH", 4, "OPTIM.LR_SCHEDULER", "cosine",
                         "OPTIM.WARMUP_EPOCH", 1, "OPTIM.WARMUP_TYPE", "constant"])
    rng = np.random.RandomState(0)
    init = [rng.randn(4, 512).astype(np.float32), rng.randn(77, 512).astype(np.float32)]
    on_card = [torch.from_numpy(x).cuda() for x in init]
    on_cpu = [torch.from_numpy(x.copy()) for x in init]
    opt, _ = build_optimizer(cfg, on_card, steps_per_epoch=3)
    ref, _ = build_optimizer(cfg, on_cpu, steps_per_epoch=3)
    for step in range(8):
        grads = [rng.randn(*x.shape).astype(np.float32) for x in init]
        g_card = [torch.from_numpy(g).cuda() for g in grads]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            opt.step(g_card)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        ref.step([torch.from_numpy(g) for g in grads])
        pairs = list(zip(on_card, on_cpu)) + [(x, y) for b in ref.buffers
                                              for x, y in zip(getattr(opt, b), getattr(ref, b))]
        for x, y in pairs:
            gap = (x.cpu().double() - y.double()).abs().max().item()
            assert gap <= 1e-6 * y.double().abs().max().item(), (name, step, gap)
    assert int(opt.count) == int(ref.count) == 8
    before = [x.clone() for x in on_card] + [x.clone() for b in opt.buffers for x in getattr(opt, b)]
    g_card[1][3, 7] = float("nan")
    opt.step(g_card)
    after = list(on_card) + [x for b in opt.buffers for x in getattr(opt, b)]
    assert all(torch.equal(x, y) for x, y in zip(before, after))
    assert int(opt.count) == 8 and int(opt.notfinite_count) == 1
