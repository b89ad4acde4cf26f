"""The port's hand-written CUDA kernels on the card, against their plain
versions.  Every test here is marked ``cuda`` and skips without a card: a
CUDA kernel has no CPU mode.

This file imports neither JAX nor the JAX package, so it runs on a machine
that has only PyTorch; skip the suite's JAX-loading conftest there:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py -q

Tolerances (max abs error) are chip_smoke.py's: fp32 1e-4 for O and LSE;
bf16 2e-2 for O (one output ulp near 2-4 is 0.016) and 1e-2 for LSE.
"""

import numpy as np
import pytest
import torch

from fsvlm_tpu_torch.ops import attention, flash_attention
from fsvlm_tpu_torch.ops.layers import linear

pytestmark = pytest.mark.cuda

TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 1e-2)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernels have no CPU mode")
    return torch.device("cuda")


def _qkv_views(B, H, L, dtype, seed):
    """q, k, v as mha makes them: strided (B, H, L, 64) views of one
    (B, L, 3*H*64) projection."""
    qkv = np.random.RandomState(seed).randn(B, L, 3 * H * 64).astype(np.float32)
    qkv = torch.from_numpy(qkv).cuda().to(dtype)
    return [t.view(B, L, H, 64).transpose(1, 2) for t in qkv.split(H * 64, dim=-1)]


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
