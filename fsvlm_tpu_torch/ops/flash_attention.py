"""Attention, forward and backward: the hand-written Hopper kernels and
their plain PyTorch versions, in three families, and the dispatch between
them.

- Head dim 64 (``kernels/flash_attn_fwd.cu``, ``kernels/flash_attn_bwd.cu``):
  counterpart of fsvlm_tpu.ops.flash_attention's head-packed attention
  (``packed_attention`` :753-844): the forward ``_hp_fwd_kernel`` (:544)
  gives O and the per-head logsumexp; the backward ``_hp_vjp_bwd`` (:768)
  computes delta = rowsum(dO * O) outside any kernel and runs
  ``_hp_bwd_dkv_kernel`` (:599) and ``_hp_bwd_dq_kernel`` (:648).  The TPU's
  two-heads-per-128-lanes packing is not carried over.  Entry:
  ``attention_fwd``.
- Blockwise, any head dim (``kernels/blockwise_attn_fwd.cu``,
  ``kernels/blockwise_attn_bwd.cu``): counterpart of ``blockwise_attention``
  (:413-516): ``_blockwise_fwd_kernel`` (:232), ``_blockwise_dkv_kernel``
  (:324) and ``_blockwise_dq_kernel`` (:372).  Entry: ``blockwise_attention``.
- Whole-sequence, any head dim (``kernels/fused_attn_fwd.cu``,
  ``kernels/fused_attn_bwd.cu``): counterpart of ``fused_attention``
  (:72-203): ``_attn_kernel`` (:32), a softmax normalized over the whole row
  before P is rounded, and ``_attn_bwd_kernel`` (:116), which recomputes
  that P from q, k and the mask (no logsumexp is saved) and takes delta from
  it; on the card a row pre-pass and two backward kernels.  Entry:
  ``fused_attention``.
- ``attention_dispatch`` (:863-904) picks the family per call from
  ``FSVLM_FORCE_PALLAS``; mha calls it.  Where JAX takes XLA's attention
  (the variable unset) and a kernel of the port computes the same
  function, the port takes the kernel; it takes ``reference_attention``,
  the port of XLA's path (``_reference_attention`` :51-69), only where no
  kernel can: a per-example (B, 1, 1, L) broadcast mask.

In bf16 every kernel runs on the tensor cores (``mma.sync``;
``kernels/mma_attn.cuh``, ``kernels/mma_flash_fwd.cuh``): the three forwards,
the whole-sequence backward, and the d = 64 and blockwise backwards, whose
dK/dV and dQ kernels are the whole-sequence backward's reading the
forward's LSE instead of a row max and sum.  In fp32 every kernel is FMA
tiles.  The blockwise and whole-sequence kernels are instantiated at head
dims 32, 64, 128, 192 and 256 (d zero-padded up to the next); past 256 they
run the FMA tiles at 256 in column passes for both dtypes, each pass summing
S over the whole head dim and writing 256 columns of the output, as the TPU
pads d to a multiple of 128 (:82, :168, :281, :441).

Each entry is one ``torch.autograd.Function``, differentiable with respect
to q, k and v: for CUDA tensors it launches the family's forward kernel and,
in the backward, its backward kernels; for CPU tensors, or under
``impl="plain"``, which only comparisons pass, it runs the plain versions.
A build or launch error propagates: there is no fallback.  The kernels are
the operators ``torch.ops.fsvlm.flash_attn_fwd_d64``,
``torch.ops.fsvlm.flash_attn_bwd_d64``, ``torch.ops.fsvlm.blockwise_attn_fwd``,
``torch.ops.fsvlm.blockwise_attn_bwd``, ``torch.ops.fsvlm.fused_attn_fwd``
and ``torch.ops.fsvlm.fused_attn_bwd`` (CUDA only, with fake
implementations for shape propagation); their libraries are built and
loaded at the first launch, not at import.
"""

import ctypes
import os
from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable
from torch.utils.checkpoint import checkpoint

D = 64
BLOCK_Q = 64  # query tile of the kernels; the plain versions walk the same tiles
BLOCK_K = 64  # key tile
_M_INIT = -1e30
_L_MIN = 1e-30

KERNEL = "flash_attn_fwd_d64"
KERNEL_DKV = "flash_attn_bwd_dkv_d64"
KERNEL_DQ = "flash_attn_bwd_dq_d64"
BW_KERNEL = "blockwise_attn_fwd"
BW_KERNEL_DKV = "blockwise_attn_bwd_dkv"
BW_KERNEL_DQ = "blockwise_attn_bwd_dq"
FUSED_KERNEL = "fused_attn_fwd"
FUSED_KERNEL_STATS = "fused_attn_bwd_stats"  # the backward's row pre-pass
FUSED_KERNEL_DKV = "fused_attn_bwd_dkv"
FUSED_KERNEL_DQ = "fused_attn_bwd_dq"
# launches of each kernel, counted where the wrapper launches it (and nowhere
# else) so that a run can show its main path went through the kernel
LAUNCHES = {name: 0 for name in (KERNEL, KERNEL_DKV, KERNEL_DQ,
                                 BW_KERNEL, BW_KERNEL_DKV, BW_KERNEL_DQ,
                                 FUSED_KERNEL, FUSED_KERNEL_STATS, FUSED_KERNEL_DKV,
                                 FUSED_KERNEL_DQ)}

# the blockwise kernels' head-dim instantiations and, per instantiation, the
# forward's key tile and the backward's own tile (keys for dK/dV, queries
# for dQ): the bf16 forward (mma_flash_fwd.cuh) walks 64-key tiles at every
# D, and in bf16 the key tile decides how P is rounded; the backward's are
# the fp32 kernels' (blockwise_attn.cuh's BwdTile).  (The fp32 forward walks
# 32-key tiles at D = 128, which in fp32 changes only the order of sums; so
# do the bf16 backward's tiles (mma_attn.cuh), since no backward rounds P.)
# Past 256 the kernels run D = 256's FMA tiles in column passes, bf16 too,
# whose forward walks 64-key tiles as well.
BW_TILES = {32: (64, 64), 64: (64, 64), 128: (64, 32), 192: (64, 32), 256: (64, 32)}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _acc_dtype(dtype):
    """The plain versions accumulate in fp32, as the kernels do (float64
    inputs stay float64, so that gradcheck can test the arithmetic)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def reference_attention_fwd(q, k, v, mask=None):
    """Plain PyTorch version of the d = 64 forward kernel, step by step:
    key tiles of BLOCK_K, online softmax with fp32 scores / running max
    (from -1e30) / running sum, P rounded to the input dtype before P.V,
    fp32 accumulation, l clamped to 1e-30.  Returns (O in q's dtype, LSE
    fp32 (B, H, L))."""
    return _tiled_fwd(q, k, v, mask, BLOCK_K)


def _head_dim(d):
    """ValueError unless d is a head dim the kernels take: any d >= 1."""
    if d < 1:
        raise ValueError(f"the attention kernels take head dims >= 1, got {d}")


def _bw_tiles(d):
    """The blockwise kernels' (forward key tile, backward own tile) for head
    dim d: those of the instantiation that holds it, past 256 of D = 256."""
    _head_dim(d)
    return next((t for dp, t in sorted(BW_TILES.items()) if d <= dp), BW_TILES[max(BW_TILES)])


def reference_blockwise_fwd(q, k, v, mask=None):
    """Plain PyTorch version of the blockwise forward kernel (TPU kernel
    :245-271) at any head dim, scale d^-1/2: the arithmetic of
    ``reference_attention_fwd`` over the kernel's own key tiles.  Returns
    (O in q's dtype, LSE fp32 (B, H, L))."""
    return _tiled_fwd(q, k, v, mask, _bw_tiles(q.shape[-1])[0])


def _tiled_fwd(q, k, v, mask, block_k):
    B, H, L, d = q.shape
    scale = d ** -0.5
    acc_t = _acc_dtype(q.dtype)
    qf, kf, vf = q.to(acc_t), k.to(acc_t), v.to(acc_t)
    m = torch.full((B, H, L, 1), _M_INIT, dtype=acc_t, device=q.device)
    l = torch.zeros((B, H, L, 1), dtype=acc_t, device=q.device)
    acc = torch.zeros((B, H, L, d), dtype=acc_t, device=q.device)
    for k0 in range(0, L, block_k):
        k1 = min(L, k0 + block_k)
        s = (qf @ kf[:, :, k0:k1].transpose(-1, -2)) * scale
        if mask is not None:
            s = s + mask[:, k0:k1].to(acc_t)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + p.to(q.dtype).to(acc_t) @ vf[:, :, k0:k1]
        m = m_new
    l = l.clamp_min(_L_MIN)
    return (acc / l).to(q.dtype), (m + torch.log(l)).squeeze(-1)


def attention_delta(o, do):
    """The backward's pre-pass, delta = rowsum(dO * O) in fp32 (JAX
    :780-786): (B, H, L), contiguous."""
    acc_t = _acc_dtype(o.dtype)
    return (do.to(acc_t) * o.to(acc_t)).sum(dim=-1).contiguous()


def reference_attention_bwd(q, k, v, o, lse, do, mask=None):
    """Plain PyTorch version of the two d = 64 backward kernels, step by step
    over their tiles (key tiles of BLOCK_K, query tiles of BLOCK_Q), with
    their arithmetic: S = q k^T * scale + mask and P = exp(S - LSE) in fp32
    (P not rounded), dO/V/Q/K upcast to fp32, dV += P^T dO, dP = dO V^T,
    dS = P (dP - delta), dK += dS^T Q * scale, dQ += dS K * scale, one cast to
    the input dtype at the end.  P is not rounded, so the tiles order only
    fp32 sums: the bf16 kernels' own (64 or 128 own rows over 64-row tiles) give
    the same function.  Returns (dq, dk, dv)."""
    return _tiled_bwd(q, k, v, o, lse, do, mask, BLOCK_Q, BLOCK_K)


def reference_blockwise_bwd(q, k, v, o, lse, do, mask=None):
    """Plain PyTorch version of the two blockwise backward kernels (TPU
    kernels :334-406) at any head dim, scale d^-1/2: the arithmetic
    of ``reference_attention_bwd``, over key tiles of the fp32 dK/dV
    kernel's own tile and query tiles of 64 (P is not rounded, so the bf16
    kernels' tiles give the same function).  Returns (dq, dk, dv)."""
    return _tiled_bwd(q, k, v, o, lse, do, mask, 64, _bw_tiles(q.shape[-1])[1])


def _tiled_bwd(q, k, v, o, lse, do, mask, block_q, block_k):
    B, H, L, d = q.shape
    scale = d ** -0.5
    acc_t = _acc_dtype(q.dtype)
    qf, kf, vf, gf = (t.to(acc_t) for t in (q, k, v, do))
    delta = attention_delta(o, do).unsqueeze(-1)
    lse = lse.to(acc_t).unsqueeze(-1)
    dq, dk, dv = (torch.zeros((B, H, L, d), dtype=acc_t, device=q.device) for _ in range(3))
    for k0 in range(0, L, block_k):
        k1 = min(L, k0 + block_k)
        kt, vt = kf[:, :, k0:k1], vf[:, :, k0:k1]
        for q0 in range(0, L, block_q):
            q1 = min(L, q0 + block_q)
            qt, gt = qf[:, :, q0:q1], gf[:, :, q0:q1]
            s = (qt @ kt.transpose(-1, -2)) * scale
            if mask is not None:
                s = s + mask[q0:q1, k0:k1].to(acc_t)
            p = torch.exp(s - lse[:, :, q0:q1])
            dv[:, :, k0:k1] += p.transpose(-1, -2) @ gt
            ds = p * (gt @ vt.transpose(-1, -2) - delta[:, :, q0:q1])
            dk[:, :, k0:k1] += (ds.transpose(-1, -2) @ qt) * scale
            dq[:, :, q0:q1] += (ds @ kt) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _whole_row_probs(q, k, mask, acc_t):
    """P = softmax(q k^T * d^-1/2 + mask) over the whole row, in the order of
    the TPU kernels (:36-45, :123-130): fp32 scores, minus the row max, exp,
    divided by the row sum; an all -inf row gives NaN."""
    s = (q.to(acc_t) @ k.to(acc_t).transpose(-1, -2)) * q.shape[-1] ** -0.5
    if mask is not None:
        s = s + mask.to(acc_t)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def reference_fused_fwd(q, k, v, mask=None):
    """Plain PyTorch version of the whole-sequence forward kernel (#1,
    ``_attn_kernel`` :32-48), step by step: P over the whole row in fp32,
    normalized, THEN rounded to v's dtype; P.V accumulated in fp32; O in q's
    dtype.  No logsumexp."""
    acc_t = _acc_dtype(q.dtype)
    p = _whole_row_probs(q, k, mask, acc_t)
    return (p.to(v.dtype).to(acc_t) @ v.to(acc_t)).to(q.dtype)


def reference_fused_bwd(q, k, v, do, mask=None):
    """Plain PyTorch version of the whole-sequence backward (#2,
    ``_attn_bwd_kernel`` :116-156), step by step: P recomputed in fp32 and
    not rounded; dO and V widened to fp32; dV = P^T dO; dP = dO V^T;
    delta = rowsum(dP * P) from that unrounded P (not rowsum(dO * O));
    dS = P (dP - delta); dQ = dS K * scale, dK = dS^T Q * scale with Q and K
    widened; each cast to its input's dtype.  Returns (dq, dk, dv)."""
    acc_t = _acc_dtype(q.dtype)
    scale = q.shape[-1] ** -0.5
    qf, kf, vf, gf = (t.to(acc_t) for t in (q, k, v, do))
    p = _whole_row_probs(qf, kf, mask, acc_t)
    dv = p.transpose(-1, -2) @ gf
    dp = gf @ vf.transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dq = (ds @ kf) * scale
    dk = (ds.transpose(-1, -2) @ qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ------------------------------------------------------- XLA's attention path
def _low_precision(q):
    """JAX's ``FSVLM_ATTN_BF16`` rule (:54-59): with bf16 inputs, and the
    variable not "0", S and P stay bf16; otherwise they are fp32."""
    return q.dtype == torch.bfloat16 and os.environ.get("FSVLM_ATTN_BF16") != "0"


def _reference(q, k, v, mask, scale, s_eq, o_eq):
    low = _low_precision(q)
    acc_t = q.dtype if low else _acc_dtype(q.dtype)
    s = torch.einsum(s_eq, q.to(acc_t), k.to(acc_t)) * scale
    if mask is not None:
        s = s + mask.to(acc_t)
    if low:  # jax.nn.softmax op by op, each rounded to bf16
        e = torch.exp(s - s.amax(dim=-1, keepdim=True))
        p = e / e.sum(dim=-1, keepdim=True)
    else:
        p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum(o_eq, p, v)


def reference_attention(q, k, v, mask=None, scale=None):
    """The port of JAX's ``_reference_attention`` (:51-69), XLA's attention:
    softmax(q k^T * scale + mask) v in plain PyTorch ops, so twice
    differentiable by autograd.  q, k, v: (B, H, L, d); mask: None, (L, L),
    or any shape that broadcasts to (B, H, L, L), e.g. a per-example (B, 1,
    1, L) key bias; scale: default d^-1/2.  S and P in fp32, softmax in
    fp32, P rounded to q's dtype before P.V; with bf16 inputs and
    ``FSVLM_ATTN_BF16`` not "0", S and P stay bf16 (JAX's default)."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    return _reference(q, k, v, mask, scale, "bhqd,bhkd->bhqk", "bhqk,bhkd->bhqd")


def reference_attention_blhd(q, k, v, mask=None, scale=None):
    """``reference_attention`` on head-minor (B, L, H, d) tensors, returning
    (B, L, H, d): the port of ``_reference_attention_blhd`` (:847-862)."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    return _reference(q, k, v, mask, scale, "bqhd,bkhd->bhqk", "bhqk,bkhd->bqhd")


# ------------------------------------------------------------------ kernels
_INT, _PTR = ctypes.c_int, ctypes.c_void_p
_ARGTYPES = {  # C entry point -> ctypes argument types before (strides, stream)
    # dtype, q, k, v, mask, o, lse, B, H, L
    "fsvlm_flash_attn_fwd_d64": [_INT] + [_PTR] * 6 + [_INT] * 3,
    # dtype, q, k, v, dO, lse, delta, mask, dk, dv, B, H, L
    "fsvlm_flash_attn_bwd_dkv_d64": [_INT] + [_PTR] * 9 + [_INT] * 3,
    # dtype, q, k, v, dO, lse, delta, mask, dq, B, H, L
    "fsvlm_flash_attn_bwd_dq_d64": [_INT] + [_PTR] * 8 + [_INT] * 3,
    # the blockwise entries: the head dim after the dtype, the scale after L
    "fsvlm_blockwise_attn_fwd": [_INT] * 2 + [_PTR] * 6 + [_INT] * 3 + [ctypes.c_float],
    "fsvlm_blockwise_attn_bwd_dkv": [_INT] * 2 + [_PTR] * 9 + [_INT] * 3 + [ctypes.c_float],
    "fsvlm_blockwise_attn_bwd_dq": [_INT] * 2 + [_PTR] * 8 + [_INT] * 3 + [ctypes.c_float],
    # the whole-sequence entries: dtype, d, q, k, v, mask, o, B, H, L, scale
    "fsvlm_fused_attn_fwd": [_INT] * 2 + [_PTR] * 5 + [_INT] * 3 + [ctypes.c_float],
    # dtype, d, q, k, v, dO, mask, row max, row sum, delta, B, H, L, scale
    "fsvlm_fused_attn_bwd_stats": [_INT] * 2 + [_PTR] * 8 + [_INT] * 3 + [ctypes.c_float],
    # dtype, d, q, k, v, dO, row max, row sum, delta, mask, dk, dv, B, H, L, scale
    "fsvlm_fused_attn_bwd_dkv": [_INT] * 2 + [_PTR] * 10 + [_INT] * 3 + [ctypes.c_float],
    # dtype, d, q, k, v, dO, row max, row sum, delta, mask, dq, B, H, L, scale
    "fsvlm_fused_attn_bwd_dq": [_INT] * 2 + [_PTR] * 9 + [_INT] * 3 + [ctypes.c_float],
}


def _kernel_fn(library, entry):
    from .kernels.build import load_library

    lib = load_library(library)
    fn = getattr(lib, entry)
    if fn.argtypes is None:  # without them ctypes would pass pointers as 32-bit ints
        fn.argtypes = _ARGTYPES[entry] + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.fsvlm_cuda_error_string.argtypes = [ctypes.c_int]
        lib.fsvlm_cuda_error_string.restype = ctypes.c_char_p
    return lib, fn


def _call(kernel, library, entry, device, *args):
    """Launch C entry ``entry`` of ``library`` on ``device``'s current stream;
    raise on a non-zero cudaError_t, else count one launch of ``kernel``."""
    lib, fn = _kernel_fn(library, entry)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: "
                           f"{lib.fsvlm_cuda_error_string(err).decode()} ({err})")
    LAUNCHES[kernel] += 1


def _ptr(t):
    return None if t is None else t.data_ptr()


def _strides(*tensors):
    """The (b, h, l) element strides of each tensor, as a C array."""
    flat = [s for t in tensors for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(flat))(*flat)


def _blhd(q):
    """An uninitialized (B, H, L, d) tensor laid out (B, L, H, d) in memory,
    so that mha's merge of the heads (and of their gradients) is a view."""
    B, H, L, d = q.shape
    return torch.empty((B, L, H, d), dtype=q.dtype, device=q.device).transpose(1, 2)


def _check_inputs(q, k, v, mask, family="packed"):
    """Raise on what the kernels of ``family`` do not take: the d = 64 family
    needs head dim 64, the blockwise and whole-sequence ones any d >= 1."""
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("q, k, v must lie on one CUDA device")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share a dtype in {list(_DTYPE_CODES)}, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must be (B, H, L, d) of one shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if family in ("blockwise", "fused"):
        _head_dim(q.shape[-1])
    elif q.shape[-1] != D:
        raise ValueError(f"this kernel takes head dim {D}, got {q.shape[-1]}")
    if min(t.stride(-1) for t in (q, k, v)) != 1 or max(t.stride(-1) for t in (q, k, v)) != 1:
        raise ValueError("q, k, v need a unit stride along the head dim")
    L = q.shape[2]
    if mask is not None and (mask.shape != (L, L) or mask.device != q.device):
        raise ValueError(f"mask must be ({L}, {L}) on {q.device}, got "
                         f"{tuple(mask.shape)} on {mask.device}")


def _check_mask(mask):
    if mask is not None and (mask.dtype != torch.float32 or not mask.is_contiguous()):
        raise ValueError("mask must be a contiguous float32 (L, L)")


def _check_do(q, do):
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device or do.stride(-1) != 1:
        raise ValueError(f"dO must be {tuple(q.shape)} {q.dtype} on {q.device} with a unit "
                         f"head-dim stride, got {tuple(do.shape)} {do.dtype} on {do.device}")


def _check_bwd_inputs(q, k, v, do, lse, delta, mask, family="packed"):
    _check_inputs(q, k, v, mask, family)
    _check_do(q, do)
    for name, t in (("lse", lse), ("delta", delta)):
        if (t.shape != q.shape[:3] or t.dtype != torch.float32 or t.device != q.device
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 {tuple(q.shape[:3])} on "
                             f"{q.device}")
    _check_mask(mask)


def _launch(q, k, v, mask):
    """Launch the d = 64 forward kernel on checked inputs (mask: (L, L) fp32
    contiguous)."""
    B, H, L, _ = q.shape
    o = _blhd(q)
    lse = torch.empty((B, H, L), dtype=torch.float32, device=q.device)
    _call(KERNEL, "flash_attn_fwd", "fsvlm_flash_attn_fwd_d64", q.device,
          _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(mask),
          o.data_ptr(), lse.data_ptr(), B, H, L, _strides(q, k, v, o))
    return o, lse


def _bwd_args(q, k, v, do, lse, delta, mask):
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), _ptr(mask))


def _launch_dkv(q, k, v, do, lse, delta, mask):
    """Launch the d = 64 dK/dV kernel on checked inputs; returns (dk, dv)."""
    B, H, L, _ = q.shape
    dk, dv = _blhd(q), _blhd(q)
    _call(KERNEL_DKV, "flash_attn_bwd", "fsvlm_flash_attn_bwd_dkv_d64", q.device,
          _DTYPE_CODES[q.dtype], *_bwd_args(q, k, v, do, lse, delta, mask), dk.data_ptr(),
          dv.data_ptr(), B, H, L, _strides(q, k, v, do, dk, dv))
    return dk, dv


def _launch_dq(q, k, v, do, lse, delta, mask):
    """Launch the d = 64 dQ kernel on checked inputs; returns dq."""
    B, H, L, _ = q.shape
    dq = _blhd(q)
    _call(KERNEL_DQ, "flash_attn_bwd", "fsvlm_flash_attn_bwd_dq_d64", q.device,
          _DTYPE_CODES[q.dtype], *_bwd_args(q, k, v, do, lse, delta, mask), dq.data_ptr(),
          B, H, L, _strides(q, k, v, do, dq, dq))
    return dq


def _bw_launch(q, k, v, mask):
    """Launch the blockwise forward kernel on checked inputs (mask: (L, L)
    fp32 contiguous); returns (o, lse)."""
    B, H, L, d = q.shape
    o = _blhd(q)
    lse = torch.empty((B, H, L), dtype=torch.float32, device=q.device)
    _call(BW_KERNEL, "blockwise_attn_fwd", "fsvlm_blockwise_attn_fwd", q.device,
          _DTYPE_CODES[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(mask),
          o.data_ptr(), lse.data_ptr(), B, H, L, d ** -0.5, _strides(q, k, v, o))
    return o, lse


def _bw_launch_dkv(q, k, v, do, lse, delta, mask):
    """Launch the blockwise dK/dV kernel on checked inputs; returns (dk, dv)."""
    B, H, L, d = q.shape
    dk, dv = _blhd(q), _blhd(q)
    _call(BW_KERNEL_DKV, "blockwise_attn_bwd", "fsvlm_blockwise_attn_bwd_dkv", q.device,
          _DTYPE_CODES[q.dtype], d, *_bwd_args(q, k, v, do, lse, delta, mask), dk.data_ptr(),
          dv.data_ptr(), B, H, L, d ** -0.5, _strides(q, k, v, do, dk, dv))
    return dk, dv


def _bw_launch_dq(q, k, v, do, lse, delta, mask):
    """Launch the blockwise dQ kernel on checked inputs; returns dq."""
    B, H, L, d = q.shape
    dq = _blhd(q)
    _call(BW_KERNEL_DQ, "blockwise_attn_bwd", "fsvlm_blockwise_attn_bwd_dq", q.device,
          _DTYPE_CODES[q.dtype], d, *_bwd_args(q, k, v, do, lse, delta, mask), dq.data_ptr(),
          B, H, L, d ** -0.5, _strides(q, k, v, do, dq))
    return dq


def _fused_launch(q, k, v, mask):
    """Launch the whole-sequence forward kernel on checked inputs; returns o."""
    B, H, L, d = q.shape
    o = _blhd(q)
    _call(FUSED_KERNEL, "fused_attn_fwd", "fsvlm_fused_attn_fwd", q.device,
          _DTYPE_CODES[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(mask),
          o.data_ptr(), B, H, L, d ** -0.5, _strides(q, k, v, o))
    return o


def _fused_launch_stats(q, k, v, do, mask):
    """Launch the whole-sequence backward's row pre-pass on checked inputs;
    returns (row max, row sum, delta), each (B, H, L) fp32 contiguous."""
    B, H, L, d = q.shape
    row_max, row_sum, delta = torch.empty((3, B, H, L), dtype=torch.float32, device=q.device)
    _call(FUSED_KERNEL_STATS, "fused_attn_bwd", "fsvlm_fused_attn_bwd_stats", q.device,
          _DTYPE_CODES[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
          _ptr(mask), row_max.data_ptr(), row_sum.data_ptr(), delta.data_ptr(), B, H, L,
          d ** -0.5, _strides(q, k, v, do))
    return row_max, row_sum, delta


def _fused_launch_dkv(q, k, v, do, stats, mask):
    """Launch the whole-sequence dK/dV kernel on checked inputs; returns (dk, dv)."""
    B, H, L, d = q.shape
    dk, dv = _blhd(q), _blhd(q)
    _call(FUSED_KERNEL_DKV, "fused_attn_bwd", "fsvlm_fused_attn_bwd_dkv", q.device,
          _DTYPE_CODES[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
          *(t.data_ptr() for t in stats), _ptr(mask), dk.data_ptr(), dv.data_ptr(), B, H, L,
          d ** -0.5, _strides(q, k, v, do, dk, dv))
    return dk, dv


def _fused_launch_dq(q, k, v, do, stats, mask):
    """Launch the whole-sequence dQ kernel on checked inputs; returns dq."""
    B, H, L, d = q.shape
    dq = _blhd(q)
    _call(FUSED_KERNEL_DQ, "fused_attn_bwd", "fsvlm_fused_attn_bwd_dq", q.device,
          _DTYPE_CODES[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
          *(t.data_ptr() for t in stats), _ptr(mask), dq.data_ptr(), B, H, L, d ** -0.5,
          _strides(q, k, v, do, dq))
    return dq


@torch.library.custom_op("fsvlm::flash_attn_fwd_d64", mutates_args=(), device_types="cuda")
def _flash_attn_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       mask: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """The d = 64 forward kernel as a PyTorch operator
    (``torch.ops.fsvlm.flash_attn_fwd_d64``); inputs are checked by
    ``_kernel_fwd``."""
    return _launch(q, k, v, mask)


@torch.library.custom_op("fsvlm::blockwise_attn_fwd", mutates_args=(), device_types="cuda")
def _blockwise_attn_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           mask: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """The blockwise forward kernel as a PyTorch operator
    (``torch.ops.fsvlm.blockwise_attn_fwd``); inputs are checked here."""
    _check_inputs(q, k, v, mask, "blockwise")
    _check_mask(mask)
    return _bw_launch(q, k, v, mask)


def _fwd_fake(q, k, v, mask):
    B, H, L, _ = q.shape
    return _blhd(q), q.new_empty((B, H, L), dtype=torch.float32)


_flash_attn_fwd_op.register_fake(_fwd_fake)
_blockwise_attn_fwd_op.register_fake(_fwd_fake)


@torch.library.custom_op("fsvlm::flash_attn_bwd_d64", mutates_args=(), device_types="cuda")
def _flash_attn_bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
                       lse: torch.Tensor, delta: torch.Tensor, mask: Optional[torch.Tensor]
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The two d = 64 backward kernels as one PyTorch operator
    (``torch.ops.fsvlm.flash_attn_bwd_d64``): (dq, dk, dv), each laid out
    (B, L, H, d) in memory.  Inputs are checked here."""
    _check_bwd_inputs(q, k, v, do, lse, delta, mask)
    dk, dv = _launch_dkv(q, k, v, do, lse, delta, mask)
    return _launch_dq(q, k, v, do, lse, delta, mask), dk, dv


@torch.library.custom_op("fsvlm::blockwise_attn_bwd", mutates_args=(), device_types="cuda")
def _blockwise_attn_bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
                           lse: torch.Tensor, delta: torch.Tensor, mask: Optional[torch.Tensor]
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The two blockwise backward kernels as one PyTorch operator
    (``torch.ops.fsvlm.blockwise_attn_bwd``): (dq, dk, dv), each laid out
    (B, L, H, d) in memory.  Inputs are checked here."""
    _check_bwd_inputs(q, k, v, do, lse, delta, mask, "blockwise")
    dk, dv = _bw_launch_dkv(q, k, v, do, lse, delta, mask)
    return _bw_launch_dq(q, k, v, do, lse, delta, mask), dk, dv


def _bwd_fake(q, k, v, do, lse, delta, mask):
    return _blhd(q), _blhd(q), _blhd(q)


_flash_attn_bwd_op.register_fake(_bwd_fake)
_blockwise_attn_bwd_op.register_fake(_bwd_fake)


@torch.library.custom_op("fsvlm::fused_attn_fwd", mutates_args=(), device_types="cuda")
def _fused_attn_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       mask: Optional[torch.Tensor]) -> torch.Tensor:
    """The whole-sequence forward kernel as a PyTorch operator
    (``torch.ops.fsvlm.fused_attn_fwd``): O laid out (B, L, H, d) in
    memory.  Inputs are checked here."""
    _check_inputs(q, k, v, mask, "fused")
    _check_mask(mask)
    return _fused_launch(q, k, v, mask)


@torch.library.custom_op("fsvlm::fused_attn_bwd", mutates_args=(), device_types="cuda")
def _fused_attn_bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
                       mask: Optional[torch.Tensor]
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The whole-sequence backward as one PyTorch operator
    (``torch.ops.fsvlm.fused_attn_bwd``): the row pre-pass (row max, row
    sum, delta), then the dK/dV and dQ kernels; (dq, dk, dv), each laid out
    (B, L, H, d) in memory.  Inputs are checked here."""
    _check_inputs(q, k, v, mask, "fused")
    _check_do(q, do)
    _check_mask(mask)
    stats = _fused_launch_stats(q, k, v, do, mask)
    dk, dv = _fused_launch_dkv(q, k, v, do, stats, mask)
    return _fused_launch_dq(q, k, v, do, stats, mask), dk, dv


_fused_attn_fwd_op.register_fake(lambda q, k, v, mask: _blhd(q))
_fused_attn_bwd_op.register_fake(lambda q, k, v, do, mask: (_blhd(q), _blhd(q), _blhd(q)))


def _kernel_fwd(q, k, v, mask):
    _check_inputs(q, k, v, mask)
    return _flash_attn_fwd_op(q, k, v, mask)


def _kernel_bwd(q, k, v, o, lse, do, mask, op=_flash_attn_bwd_op):
    """The delta pre-pass, then backward operator ``op``: (dq, dk, dv)."""
    if do.stride(-1) != 1:  # e.g. the expanded gradient of a sum
        do = do.contiguous()
    return op(q, k, v, do, lse, attention_delta(o, do), mask)


def _bw_kernel_bwd(q, k, v, o, lse, do, mask):
    return _kernel_bwd(q, k, v, o, lse, do, mask, op=_blockwise_attn_bwd_op)


def _fused_kernel_bwd(q, k, v, do, mask):
    if do.stride(-1) != 1:  # e.g. the expanded gradient of a sum
        do = do.contiguous()
    return _fused_attn_bwd_op(q, k, v, do, mask)


# family -> (plain forward, plain backward, kernel forward, kernel backward);
# the flash families' forwards give (O, LSE) and their backwards take
# (q, k, v, O, LSE, dO, mask); the whole-sequence ("fused") forward gives O
# and its backward takes (q, k, v, dO, mask)
_FAMILIES = {
    "packed": (reference_attention_fwd, reference_attention_bwd, _kernel_fwd, _kernel_bwd),
    "blockwise": (reference_blockwise_fwd, reference_blockwise_bwd, _blockwise_attn_fwd_op,
                  _bw_kernel_bwd),
    "fused": (reference_fused_fwd, reference_fused_bwd, _fused_attn_fwd_op, _fused_kernel_bwd),
}


def _kernel_mask(mask):
    """The mask as the kernels read it: fp32 (L, L) row-major."""
    return None if mask is None else mask.to(torch.float32).contiguous()


class _FlashAttention(torch.autograd.Function):
    """Attention through one flash family, forward and backward (``plain``:
    its plain versions).  Saves q, k, v, the mask, O and LSE; LSE and the
    mask take no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, mask, family, plain):
        ref_fwd, _, kernel_fwd, _ = _FAMILIES[family]
        if plain:
            o, lse = ref_fwd(q, k, v, mask)
        else:
            mask = _kernel_mask(mask)
            o, lse = kernel_fwd(q, k, v, mask)
        ctx.family, ctx.plain = family, plain
        ctx.save_for_backward(q, k, v, mask, o, lse)
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    @once_differentiable
    def backward(ctx, do, _dlse):
        q, k, v, mask, o, lse = ctx.saved_tensors
        _, ref_bwd, _, kernel_bwd = _FAMILIES[ctx.family]
        dq, dk, dv = (ref_bwd if ctx.plain else kernel_bwd)(q, k, v, o, lse, do, mask)
        return dq, dk, dv, None, None, None


class _FusedAttention(torch.autograd.Function):
    """Whole-sequence attention, forward and backward (``plain``: the plain
    versions).  Saves q, k, v and the mask only, as the JAX custom VJP's
    residuals (:159-160): the backward recomputes P.  The mask takes no
    gradient."""

    @staticmethod
    def forward(ctx, q, k, v, mask, plain):
        ref_fwd, _, kernel_fwd, _ = _FAMILIES["fused"]
        if plain:
            o = ref_fwd(q, k, v, mask)
        else:
            mask = _kernel_mask(mask)
            o = kernel_fwd(q, k, v, mask)
        ctx.plain = plain
        ctx.save_for_backward(q, k, v, mask)
        return o

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        q, k, v, mask = ctx.saved_tensors
        _, ref_bwd, _, kernel_bwd = _FAMILIES["fused"]
        dq, dk, dv = (ref_bwd if ctx.plain else kernel_bwd)(q, k, v, do, mask)
        return dq, dk, dv, None, None


def _plain(impl, q):
    if impl not in (None, "plain"):
        raise ValueError(f"impl must be None or 'plain', got {impl!r}")
    return impl == "plain" or q.device.type == "cpu"


def attention_fwd(q, k, v, mask=None, impl=None):
    """softmax(q k^T / sqrt(d) + mask) v and its logsumexp, differentiable
    with respect to q, k and v, through the d = 64 kernels (#6-#8).

    q, k, v: (B, H, L, 64) float32 or bfloat16; mask: optional (L, L)
    additive, shared over batch and heads.  Returns (O (B, H, L, 64) in q's
    dtype, LSE (B, H, L) float32).  CUDA tensors go through the hand-written
    kernels, forward and backward; CPU tensors, or ``impl="plain"``, through
    the plain versions."""
    return _FlashAttention.apply(q, k, v, mask, "packed", _plain(impl, q))


def blockwise_attention(q, k, v, mask=None, block_q=256, block_k=512, impl=None):
    """softmax(q k^T * d^-1/2 + mask) v through the blockwise kernels
    (#3-#5), differentiable (first order) with respect to q, k and v; the
    counterpart of the JAX package's ``blockwise_attention``.

    q, k, v: (B, H, L, d), any d >= 1, float32 or bfloat16; mask: optional
    (L, L) additive, shared over batch and heads.
    Returns O (B, H, L, d) in q's dtype; its LSE and O are saved for the
    backward.  ``block_q`` / ``block_k`` are the JAX signature's tile sizes,
    validated and otherwise unused: the card's tiles are the kernels' own
    (64 keys in the forward, which the plain version walks too), which
    gives the same function up to the order of fp32 sums.  CUDA tensors go
    through the kernels; CPU tensors, or ``impl="plain"``, through the plain
    versions."""
    for name, b in (("block_q", block_q), ("block_k", block_k)):
        if not isinstance(b, int) or b < 1:
            raise ValueError(f"{name} must be a positive int, got {b!r}")
    _head_dim(q.shape[-1])
    return _FlashAttention.apply(q, k, v, mask, "blockwise", _plain(impl, q))[0]


def fused_attention(q, k, v, mask=None, impl=None):
    """softmax(q k^T * d^-1/2 + mask) v through the whole-sequence kernels
    (#1-#2), differentiable (first order) with respect to q, k and v; the
    counterpart of the JAX package's ``fused_attention``.

    q, k, v: (B, H, L, d), any d >= 1, as JAX, float32 or bfloat16; mask:
    optional (L, L) additive, shared over batch and heads.  Any other mask
    shape raises ValueError, as JAX's ``full_mask.at[:L, :L].add(mask)``
    (:90, :175) does.  Returns O
    (B, H, L, d) in q's dtype; only q, k, v and the mask are saved for the
    backward.  CUDA tensors go through the kernels; CPU tensors, or
    ``impl="plain"``, through the plain versions."""
    _head_dim(q.shape[-1])
    L = q.shape[2]
    if mask is not None and tuple(mask.shape) != (L, L):
        raise ValueError(f"fused_attention takes an (L, L) = ({L}, {L}) mask, got "
                         f"{tuple(mask.shape)}")
    return _FusedAttention.apply(q, k, v, mask, _plain(impl, q))


def attention_route(head_dim, mask=None, heads=None):
    """The family ``attention_dispatch`` takes for this head dim, mask and
    head count under the current ``FSVLM_FORCE_PALLAS``: "packed" (the d =
    64 kernels #6-#8), "blockwise" (#3-#5), "fused" (#1-#2) or "reference"
    (``reference_attention``, XLA's path), as JAX's :863-904 reads the
    variable.

    - ``legacy``: "fused" (the whole-sequence kernels take an (L, L) mask or
      none, at any head dim);
    - ``1``: "blockwise";
    - ``packed``: "packed" at d = 64 with an even head count (or ``heads``
      not given), else "blockwise": JAX packs two heads per 128 lanes and
      falls through at :874-879 otherwise;
    - under ``legacy``, ``1`` and ``packed``, a mask that is not 2-D (a
      per-example (B, 1, 1, L) key bias) raises ValueError: JAX sends it to
      ``fused_attention``, whose (L, L) mask cannot take it, and raises;
    - unset or any other value: JAX takes XLA's attention.  The one rule:
      where a kernel of the port computes the same function, the port takes
      the kernel (its own default, ROADMAP B4): "packed" at d = 64, else
      "blockwise" (at any head dim), with an (L, L) mask or none.  A
      broadcast mask, which no kernel takes, goes to "reference"."""
    force = os.environ.get("FSVLM_FORCE_PALLAS")
    shared = mask is None or mask.dim() == 2
    if force in ("legacy", "1", "packed") and not shared:
        raise ValueError(
            f"FSVLM_FORCE_PALLAS={force} sends a {mask.dim()}-D mask to the whole-sequence "
            f"kernels, whose (L, L) mask cannot take it (JAX raises there too)")
    if force == "legacy":
        return "fused"
    if not shared:
        return "reference"
    if force == "packed" and heads is not None and heads % 2:
        return "blockwise"
    if force != "1" and head_dim == D:
        return "packed"
    return "blockwise"


def attention_dispatch(q, k, v, mask=None, impl=None):
    """softmax(q k^T * d^-1/2 + mask) v through the family that
    ``attention_route`` picks, reading ``FSVLM_FORCE_PALLAS`` at each call
    as the JAX package reads it at each trace (:863-904).  Returns O
    (B, H, L, d) in q's dtype, differentiable with respect to q, k and v.

    The JAX package's unset default is XLA's attention; the port's default
    stays its kernels wherever one computes the same function (ROADMAP B4),
    and ``reference_attention`` takes what no kernel can, a broadcast mask.
    On that route, as JAX's :891-903, ``FSVLM_ATTN_REMAT=1`` recomputes the
    scores and softmax in the backward (``torch.utils.checkpoint``) instead
    of keeping P, and ``FSVLM_ATTN_BF16`` sets its precision.  ``impl="plain"``,
    or CPU tensors, take the plain version of the kernel family the route
    picks.  ``impl="reference"`` takes ``reference_attention`` whatever the
    variable says: JAX's unset default, for a caller that differentiates
    the attention twice (the kernels' backwards are first order only)."""
    if impl == "reference":
        route = "reference"
    else:
        route = attention_route(q.shape[-1], mask, heads=q.shape[1])
    if route == "packed":
        return attention_fwd(q, k, v, mask, impl=impl)[0]
    if route == "fused":
        return fused_attention(q, k, v, mask, impl=impl)
    if route == "reference":
        if os.environ.get("FSVLM_ATTN_REMAT") == "1":
            return checkpoint(reference_attention, q, k, v, mask, use_reentrant=False)
        return reference_attention(q, k, v, mask)
    return blockwise_attention(q, k, v, mask, impl=impl)
