"""Flash attention at head dim 64, forward and backward: the hand-written
Hopper kernels (``kernels/flash_attn_fwd.cu``, ``kernels/flash_attn_bwd.cu``)
and their plain PyTorch versions.

Counterpart of fsvlm_tpu.ops.flash_attention's head-packed attention
(``packed_attention`` :753-844): the forward ``_hp_fwd_kernel`` (:544) gives
O and the per-head logsumexp; the backward ``_hp_vjp_bwd`` (:768) computes
delta = rowsum(dO * O) outside any kernel and runs ``_hp_bwd_dkv_kernel``
(:599) and ``_hp_bwd_dq_kernel`` (:648).  The TPU's two-heads-per-128-lanes
packing is not carried over.

``attention_fwd`` is differentiable with respect to q, k and v: one
``torch.autograd.Function`` launches the forward kernel and, in the
backward, the two backward kernels for CUDA tensors, and runs the plain
versions (``reference_attention_fwd`` / ``reference_attention_bwd``) for CPU
tensors or under ``impl="plain"``, which only comparisons pass.  A build or
launch error propagates: there is no fallback.  The kernels are the
operators ``torch.ops.fsvlm.flash_attn_fwd_d64`` and
``torch.ops.fsvlm.flash_attn_bwd_d64`` (CUDA only, with fake implementations
for shape propagation); their libraries are built and loaded at the first
launch, not at import.
"""

import ctypes
from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

D = 64
BLOCK_Q = 64  # query tile of the kernels; the plain versions walk the same tiles
BLOCK_K = 64  # key tile
_M_INIT = -1e30
_L_MIN = 1e-30

KERNEL = "flash_attn_fwd_d64"
KERNEL_DKV = "flash_attn_bwd_dkv_d64"
KERNEL_DQ = "flash_attn_bwd_dq_d64"
# launches of each kernel, counted where the wrapper launches it (and nowhere
# else) so that a run can show its main path went through the kernel
LAUNCHES = {KERNEL: 0, KERNEL_DKV: 0, KERNEL_DQ: 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _acc_dtype(dtype):
    """The plain versions accumulate in fp32, as the kernels do (float64
    inputs stay float64, so that gradcheck can test the arithmetic)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def reference_attention_fwd(q, k, v, mask=None):
    """Plain PyTorch version of the forward kernel, step by step: key tiles
    of BLOCK_K, online softmax with fp32 scores / running max (from -1e30) /
    running sum, P rounded to the input dtype before P.V, fp32 accumulation,
    l clamped to 1e-30.  Returns (O in q's dtype, LSE fp32 (B, H, L))."""
    B, H, L, d = q.shape
    scale = d ** -0.5
    acc_t = _acc_dtype(q.dtype)
    qf, kf, vf = q.to(acc_t), k.to(acc_t), v.to(acc_t)
    m = torch.full((B, H, L, 1), _M_INIT, dtype=acc_t, device=q.device)
    l = torch.zeros((B, H, L, 1), dtype=acc_t, device=q.device)
    acc = torch.zeros((B, H, L, d), dtype=acc_t, device=q.device)
    for k0 in range(0, L, BLOCK_K):
        k1 = min(L, k0 + BLOCK_K)
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
    """Plain PyTorch version of the two backward kernels, step by step over
    their tiles (key tiles of BLOCK_K, query tiles of BLOCK_Q), with their
    arithmetic: S = q k^T * scale + mask and P = exp(S - LSE) in fp32 (P not
    rounded), dO/V/Q/K upcast to fp32, dV += P^T dO, dP = dO V^T,
    dS = P (dP - delta), dK += dS^T Q * scale, dQ += dS K * scale, one cast to
    the input dtype at the end.  Returns (dq, dk, dv)."""
    B, H, L, d = q.shape
    scale = d ** -0.5
    acc_t = _acc_dtype(q.dtype)
    qf, kf, vf, gf = (t.to(acc_t) for t in (q, k, v, do))
    delta = attention_delta(o, do).unsqueeze(-1)
    lse = lse.to(acc_t).unsqueeze(-1)
    dq, dk, dv = (torch.zeros((B, H, L, d), dtype=acc_t, device=q.device) for _ in range(3))
    for k0 in range(0, L, BLOCK_K):
        k1 = min(L, k0 + BLOCK_K)
        kt, vt = kf[:, :, k0:k1], vf[:, :, k0:k1]
        for q0 in range(0, L, BLOCK_Q):
            q1 = min(L, q0 + BLOCK_Q)
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


# ------------------------------------------------------------------ kernels
_ARGTYPES = {  # C entry point -> ctypes argument types
    # dtype, q, k, v, mask, o, lse, B, H, L, strides, stream
    "fsvlm_flash_attn_fwd_d64": [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3,
    # dtype, q, k, v, dO, lse, delta, mask, dk, dv, B, H, L, strides, stream
    "fsvlm_flash_attn_bwd_dkv_d64": [ctypes.c_int] + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3,
    # dtype, q, k, v, dO, lse, delta, mask, dq, B, H, L, strides, stream
    "fsvlm_flash_attn_bwd_dq_d64": [ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3,
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
    B, H, L, _ = q.shape
    return torch.empty((B, L, H, D), dtype=q.dtype, device=q.device).transpose(1, 2)


def _check_inputs(q, k, v, mask):
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("q, k, v must lie on one CUDA device")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share a dtype in {list(_DTYPE_CODES)}, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or q.shape[-1] != D or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must be (B, H, L, {D}) of one shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if min(t.stride(-1) for t in (q, k, v)) != 1 or max(t.stride(-1) for t in (q, k, v)) != 1:
        raise ValueError("q, k, v need a unit stride along the head dim")
    L = q.shape[2]
    if mask is not None and (mask.shape != (L, L) or mask.device != q.device):
        raise ValueError(f"mask must be ({L}, {L}) on {q.device}, got "
                         f"{tuple(mask.shape)} on {mask.device}")


def _check_bwd_inputs(q, k, v, do, lse, delta, mask):
    _check_inputs(q, k, v, mask)
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device or do.stride(-1) != 1:
        raise ValueError(f"dO must be {tuple(q.shape)} {q.dtype} on {q.device} with a unit "
                         f"head-dim stride, got {tuple(do.shape)} {do.dtype} on {do.device}")
    for name, t in (("lse", lse), ("delta", delta)):
        if (t.shape != q.shape[:3] or t.dtype != torch.float32 or t.device != q.device
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 {tuple(q.shape[:3])} on "
                             f"{q.device}")
    if mask is not None and (mask.dtype != torch.float32 or not mask.is_contiguous()):
        raise ValueError("mask must be a contiguous float32 (L, L)")


def _launch(q, k, v, mask):
    """Launch the forward kernel on checked inputs (mask: (L, L) fp32 contiguous)."""
    B, H, L, _ = q.shape
    o = _blhd(q)
    lse = torch.empty((B, H, L), dtype=torch.float32, device=q.device)
    _call(KERNEL, "flash_attn_fwd", "fsvlm_flash_attn_fwd_d64", q.device,
          _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(mask),
          o.data_ptr(), lse.data_ptr(), B, H, L, _strides(q, k, v, o))
    return o, lse


def _bwd_args(q, k, v, do, lse, delta, mask):
    return (_DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), _ptr(mask))


def _launch_dkv(q, k, v, do, lse, delta, mask):
    """Launch the dK/dV kernel on checked inputs; returns (dk, dv)."""
    B, H, L, _ = q.shape
    dk, dv = _blhd(q), _blhd(q)
    _call(KERNEL_DKV, "flash_attn_bwd", "fsvlm_flash_attn_bwd_dkv_d64", q.device,
          *_bwd_args(q, k, v, do, lse, delta, mask), dk.data_ptr(), dv.data_ptr(), B, H, L,
          _strides(q, k, v, do, dk, dv))
    return dk, dv


def _launch_dq(q, k, v, do, lse, delta, mask):
    """Launch the dQ kernel on checked inputs; returns dq."""
    B, H, L, _ = q.shape
    dq = _blhd(q)
    _call(KERNEL_DQ, "flash_attn_bwd", "fsvlm_flash_attn_bwd_dq_d64", q.device,
          *_bwd_args(q, k, v, do, lse, delta, mask), dq.data_ptr(), B, H, L,
          _strides(q, k, v, do, dq, dq))
    return dq


@torch.library.custom_op("fsvlm::flash_attn_fwd_d64", mutates_args=(), device_types="cuda")
def _flash_attn_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       mask: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel as a PyTorch operator
    (``torch.ops.fsvlm.flash_attn_fwd_d64``); inputs are checked by
    ``_kernel_fwd``."""
    return _launch(q, k, v, mask)


@_flash_attn_fwd_op.register_fake
def _(q, k, v, mask):
    B, H, L, _ = q.shape
    return _blhd(q), q.new_empty((B, H, L), dtype=torch.float32)


@torch.library.custom_op("fsvlm::flash_attn_bwd_d64", mutates_args=(), device_types="cuda")
def _flash_attn_bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
                       lse: torch.Tensor, delta: torch.Tensor, mask: Optional[torch.Tensor]
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The two backward kernels as one PyTorch operator
    (``torch.ops.fsvlm.flash_attn_bwd_d64``): (dq, dk, dv), each laid out
    (B, L, H, d) in memory.  Inputs are checked here."""
    _check_bwd_inputs(q, k, v, do, lse, delta, mask)
    dk, dv = _launch_dkv(q, k, v, do, lse, delta, mask)
    return _launch_dq(q, k, v, do, lse, delta, mask), dk, dv


@_flash_attn_bwd_op.register_fake
def _(q, k, v, do, lse, delta, mask):
    return _blhd(q), _blhd(q), _blhd(q)


def _kernel_fwd(q, k, v, mask):
    _check_inputs(q, k, v, mask)
    return _flash_attn_fwd_op(q, k, v, mask)


def _kernel_bwd(q, k, v, o, lse, do, mask):
    if do.stride(-1) != 1:  # e.g. the expanded gradient of a sum
        do = do.contiguous()
    return _flash_attn_bwd_op(q, k, v, do, lse, attention_delta(o, do), mask)


class _FlashAttention(torch.autograd.Function):
    """Attention with the kernels' backward (``plain``: the plain versions).
    Saves q, k, v, O and LSE; LSE and the mask take no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, mask, plain):
        if plain:
            o, lse = reference_attention_fwd(q, k, v, mask)
        else:
            if mask is not None:  # the kernels read an fp32 (L, L) row-major mask
                mask = mask.to(torch.float32).contiguous()
            o, lse = _kernel_fwd(q, k, v, mask)
        ctx.plain = plain
        ctx.save_for_backward(q, k, v, mask, o, lse)
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    @once_differentiable
    def backward(ctx, do, _dlse):
        q, k, v, mask, o, lse = ctx.saved_tensors
        bwd = reference_attention_bwd if ctx.plain else _kernel_bwd
        dq, dk, dv = bwd(q, k, v, o, lse, do, mask)
        return dq, dk, dv, None, None


def attention_fwd(q, k, v, mask=None, impl=None):
    """softmax(q k^T / sqrt(d) + mask) v and its logsumexp, differentiable
    with respect to q, k and v.

    q, k, v: (B, H, L, 64) float32 or bfloat16; mask: optional (L, L)
    additive, shared over batch and heads.  Returns (O (B, H, L, 64) in q's
    dtype, LSE (B, H, L) float32).  CUDA tensors go through the hand-written
    kernels, forward and backward; CPU tensors, or ``impl="plain"``, through
    the plain versions."""
    if impl not in (None, "plain"):
        raise ValueError(f"impl must be None or 'plain', got {impl!r}")
    plain = impl == "plain" or q.device.type == "cpu"
    return _FlashAttention.apply(q, k, v, mask, plain)
