"""Flash-attention forward at head dim 64: the hand-written Hopper kernel
(``kernels/flash_attn_fwd.cu``) and its plain PyTorch version.

Counterpart of fsvlm_tpu.ops.flash_attention's head-packed forward
(``_hp_fwd_kernel`` / ``_hp_fwd_impl``, :544-760): the same O and per-head
logsumexp, without the TPU's two-heads-per-128-lanes packing.

``attention_fwd`` launches the kernel for CUDA tensors and takes the plain
version only for CPU tensors.  ``impl="plain"`` forces the plain version so
that a test or ``chip_smoke.py`` can compare the two; nothing on the main
path passes it.  A build or launch error propagates: there is no fallback.
The kernel is registered as the operator ``torch.ops.fsvlm.flash_attn_fwd_d64``
(CUDA only, with a fake implementation for shape propagation); its library
is built and loaded at the first launch, not at import.
"""

import ctypes
from typing import Optional, Tuple

import torch

D = 64
BLOCK_K = 64  # key tile of the kernel; the plain version walks the same tiles
_M_INIT = -1e30
_L_MIN = 1e-30

KERNEL = "flash_attn_fwd_d64"
# launches of each kernel, counted where the wrapper launches it (and nowhere
# else) so that a run can show its main path went through the kernel
LAUNCHES = {KERNEL: 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def reference_attention_fwd(q, k, v, mask=None):
    """Plain PyTorch version of the kernel, step by step: key tiles of
    BLOCK_K, online softmax with fp32 scores / running max (from -1e30) /
    running sum, P rounded to the input dtype before P.V, fp32 accumulation,
    l clamped to 1e-30.  Returns (O in q's dtype, LSE fp32 (B, H, L))."""
    B, H, L, d = q.shape
    scale = d ** -0.5
    qf, kf, vf = q.float(), k.float(), v.float()
    m = torch.full((B, H, L, 1), _M_INIT, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, L, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, L, d), dtype=torch.float32, device=q.device)
    for k0 in range(0, L, BLOCK_K):
        k1 = min(L, k0 + BLOCK_K)
        s = (qf @ kf[:, :, k0:k1].transpose(-1, -2)) * scale
        if mask is not None:
            s = s + mask[:, k0:k1].float()
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + p.to(q.dtype).float() @ vf[:, :, k0:k1]
        m = m_new
    l = l.clamp_min(_L_MIN)
    return (acc / l).to(q.dtype), (m + torch.log(l)).squeeze(-1)


def _kernel_fn():
    from .kernels.build import load_library

    lib = load_library("flash_attn_fwd")
    fn = lib.fsvlm_flash_attn_fwd_d64
    if fn.argtypes is None:  # without them ctypes would pass pointers as 32-bit ints
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 6 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.fsvlm_cuda_error_string.argtypes = [ctypes.c_int]
        lib.fsvlm_cuda_error_string.restype = ctypes.c_char_p
    return lib, fn


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


def _launch(q, k, v, mask):
    """Launch the kernel on checked inputs (mask: (L, L) fp32 contiguous)."""
    B, H, L, _ = q.shape
    # O is laid out (B, L, H, d) in memory: mha's merge of the heads is then a view
    o = torch.empty((B, L, H, D), dtype=q.dtype, device=q.device).transpose(1, 2)
    lse = torch.empty((B, H, L), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3])
    lib, fn = _kernel_fn()
    with torch.cuda.device(q.device):
        err = fn(_DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 None if mask is None else mask.data_ptr(), o.data_ptr(), lse.data_ptr(),
                 B, H, L, strides, torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{KERNEL} launch failed: "
                           f"{lib.fsvlm_cuda_error_string(err).decode()} ({err})")
    LAUNCHES[KERNEL] += 1
    return o, lse


@torch.library.custom_op("fsvlm::flash_attn_fwd_d64", mutates_args=(), device_types="cuda")
def _flash_attn_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       mask: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel as a PyTorch operator (``torch.ops.fsvlm.flash_attn_fwd_d64``);
    inputs are checked by ``_kernel_fwd``."""
    return _launch(q, k, v, mask)


@_flash_attn_fwd_op.register_fake
def _(q, k, v, mask):
    B, H, L, _ = q.shape
    o = q.new_empty((B, L, H, D)).transpose(1, 2)
    return o, q.new_empty((B, H, L), dtype=torch.float32)


def _kernel_fwd(q, k, v, mask):
    _check_inputs(q, k, v, mask)
    if mask is not None:
        mask = mask.to(torch.float32).contiguous()
    return _flash_attn_fwd_op(q, k, v, mask)


def attention_fwd(q, k, v, mask=None, impl=None):
    """softmax(q k^T / sqrt(d) + mask) v and its logsumexp.

    q, k, v: (B, H, L, 64) float32 or bfloat16; mask: optional (L, L)
    additive, shared over batch and heads.  Returns (O (B, H, L, 64) in q's
    dtype, LSE (B, H, L) float32).  CUDA tensors go through the hand-written
    kernel; CPU tensors, or ``impl="plain"``, through the plain version."""
    if impl == "plain" or (impl is None and q.device.type == "cpu"):
        return reference_attention_fwd(q, k, v, mask)
    if impl is not None:
        raise ValueError(f"impl must be None or 'plain', got {impl!r}")
    return _kernel_fwd(q, k, v, mask)
