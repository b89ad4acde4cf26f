"""The GEMM inventory of the PromptSRC and CoCoOp train steps, in analytic
FLOPs (counterpart of fsvlm_tpu.utils.flops, over the port's own
``models.clip.config.CLIPConfig``).

Every count is **true FLOPs = 2 * M * N * K** (one multiply and one add
per multiply-accumulate), listed GEMM family by GEMM family.  The towers
are frozen and only the prompts are trained, so the backward is dgrad
only: one GEMM per forward linear, two per attention einsum (both of its
operands carry gradients), and no weight-gradient GEMM.  Non-GEMM work
(LayerNorm, softmax, GELU, the optimizer) is left out: it is memory-bound
elementwise work, part of the gap to the tensor cores' rate, not of the
numerator.

A PromptSRC step is the student's image pass forward and backward, the
text pass forward and backward over the class prompts, and the frozen
teacher's image pass forward (none under CACHED_TEACHER).  The functions
and their results are the JAX package's, name for name and number for
number (``tests/test_torch_flops.py``).
"""

import dataclasses
from typing import List


@dataclasses.dataclass(frozen=True)
class Gemm:
    """One GEMM family in the step: ``count`` x ( [batch] x M·K @ K·N )."""

    name: str       # e.g. "vision_mlp1_fwd"
    op_class: str   # roofline grouping: "mlp", "qkv", "proj", "attn_bmm", ...
    m: int
    k: int
    n: int
    batch: int = 1  # batched-matmul leading dim (1 = plain GEMM)
    count: int = 1  # repetitions per step (layers x towers x ...)

    @property
    def flops(self) -> int:
        return 2 * self.m * self.k * self.n * self.batch * self.count


def _transformer_fwd(prefix, op_prefix, layers, seq, width, heads, batch,
                     mlp_ratio=4) -> List[Gemm]:
    """Per-layer GEMMs of one pre-LN CLIP transformer forward: QKV (L·B,
    D)x(D, 3D), two attention batched matmuls over B·H heads, out-proj
    (L·B, D)x(D, D), MLP (L·B, D)x(D, 4D) and (L·B, 4D)x(4D, D)."""
    d_head = width // heads
    lb = seq * batch
    return [
        Gemm(f"{prefix}_qkv", f"{op_prefix}qkv", lb, width, 3 * width, count=layers),
        Gemm(f"{prefix}_attn_qk", f"{op_prefix}attn_bmm", seq, d_head, seq,
             batch=batch * heads, count=layers),
        Gemm(f"{prefix}_attn_av", f"{op_prefix}attn_bmm", seq, seq, d_head,
             batch=batch * heads, count=layers),
        Gemm(f"{prefix}_outproj", f"{op_prefix}proj", lb, width, width, count=layers),
        Gemm(f"{prefix}_mlp1", f"{op_prefix}mlp", lb, width, mlp_ratio * width, count=layers),
        Gemm(f"{prefix}_mlp2", f"{op_prefix}mlp", lb, mlp_ratio * width, width, count=layers),
    ]


def _transformer_dgrad(prefix, op_prefix, layers, seq, width, heads, batch,
                       mlp_ratio=4) -> List[Gemm]:
    """Backward GEMMs with frozen weights, dgrad only: each linear one GEMM
    of its forward's FLOPs, each attention einsum two (dQ and dK from the
    score einsum; dP and dV from the prob@V einsum)."""
    d_head = width // heads
    lb = seq * batch
    return [
        Gemm(f"{prefix}_qkv_dgrad", f"{op_prefix}qkv", lb, 3 * width, width, count=layers),
        # score einsum bwd: dQ = dS @ K, dK = dS^T @ Q
        Gemm(f"{prefix}_attn_qk_dgrad", f"{op_prefix}attn_bmm", seq, seq, d_head,
             batch=batch * heads, count=2 * layers),
        # prob@V bwd: dP = dO @ V^T, dV = P^T @ dO
        Gemm(f"{prefix}_attn_av_dgrad", f"{op_prefix}attn_bmm", seq, d_head, seq,
             batch=batch * heads, count=layers),
        Gemm(f"{prefix}_attn_av_dgrad_v", f"{op_prefix}attn_bmm", seq, seq, d_head,
             batch=batch * heads, count=layers),
        Gemm(f"{prefix}_outproj_dgrad", f"{op_prefix}proj", lb, width, width, count=layers),
        Gemm(f"{prefix}_mlp2_dgrad", f"{op_prefix}mlp", lb, width, mlp_ratio * width,
             count=layers),
        Gemm(f"{prefix}_mlp1_dgrad", f"{op_prefix}mlp", lb, mlp_ratio * width, width,
             count=layers),
    ]


def vit_image_gemms(cfg, batch, n_vpt=0, backward=False, prefix="vision") -> List[Gemm]:
    """All GEMMs of one ViT image-tower pass over a batch; ``n_vpt`` visual
    prompt tokens beside the patch and class tokens (0 for the frozen
    teacher)."""
    assert cfg.is_vit
    seq = cfg.vision_seq_len + n_vpt
    w = cfg.vision_width
    gemms = [
        # patch embed: the conv as a (n_patches·B, 3·p·p) x (3·p·p, D) matmul
        Gemm(f"{prefix}_patch_embed", "patch", cfg.grid_size ** 2 * batch,
             3 * cfg.vision_patch_size ** 2, w),
        # output projection (class token only): (B, D) x (D, embed)
        Gemm(f"{prefix}_proj", "proj", batch, w, cfg.embed_dim),
    ]
    gemms += _transformer_fwd(prefix, "vision_", cfg.vision_layers, seq, w,
                              cfg.vision_heads, batch)
    if backward:
        gemms += _transformer_dgrad(prefix, "vision_", cfg.vision_layers, seq, w,
                                    cfg.vision_heads, batch)
        gemms.append(Gemm(f"{prefix}_proj_dgrad", "proj", batch, cfg.embed_dim, w))
        # the dgrad stops at the patch embedding's output (the prompts live
        # in token space): the conv has neither a weight nor an input grad
    return gemms


def text_gemms(cfg, n_cls, seq_len, backward=False, prefix="text") -> List[Gemm]:
    """All GEMMs of one text-tower pass over ``n_cls`` class prompts of
    ``seq_len`` tokens (the EOT-truncated length under
    MODEL.TEXT_TRUNCATE)."""
    w = cfg.transformer_width
    gemms = [Gemm(f"{prefix}_proj", "proj", n_cls, w, cfg.embed_dim)]
    gemms += _transformer_fwd(prefix, "text_", cfg.transformer_layers, seq_len, w,
                              cfg.transformer_heads, n_cls)
    if backward:
        gemms += _transformer_dgrad(prefix, "text_", cfg.transformer_layers, seq_len, w,
                                    cfg.transformer_heads, n_cls)
        gemms.append(Gemm(f"{prefix}_proj_dgrad", "proj", n_cls, cfg.embed_dim, w))
    return gemms


def promptsrc_step_gemms(cfg, batch, n_cls, text_len, n_vpt=4,
                         teacher="per_step") -> List[Gemm]:
    """The GEMMs of one PromptSRC train step.  ``teacher``: "per_step" (the
    frozen tower's forward over the augmented batch every step), "cached"
    (TRAINER.PROMPTSRC.CACHED_TEACHER: no teacher GEMMs per step) or "int8"
    (INT8_TEACHER: the same GEMMs, at int8)."""
    gemms = []
    gemms += vit_image_gemms(cfg, batch, n_vpt=n_vpt, backward=True, prefix="student")
    gemms += text_gemms(cfg, n_cls, text_len, backward=True, prefix="text")
    if teacher in ("per_step", "int8"):
        gemms += vit_image_gemms(cfg, batch, n_vpt=0, backward=False, prefix="teacher")
    elif teacher != "cached":
        raise ValueError(f"unknown teacher mode {teacher!r}")
    # logits: (B, embed) x (embed, n_cls), the student's and the teacher's (KL term)
    gemms.append(Gemm("logits", "proj", batch, cfg.embed_dim, n_cls, count=2))
    return gemms


def _scale_counts(gemms, factor) -> List[Gemm]:
    return [dataclasses.replace(g, count=g.count * factor) for g in gemms]


def cocoop_step_gemms(cfg, batch, n_cls, text_len, chunk=0, remat=True) -> List[Gemm]:
    """The GEMMs of one CoCoOp train step (``trainers/cocoop.py``).

    The meta-net conditions the context on each image, so the text tower
    runs over batch * n_cls prompt rows forward and backward; the image
    tower is frozen with nothing learnable before it: forward only.
    ``chunk`` is TRAINER.COCOOP.CLASS_CHUNK: > 0 builds the logits class
    block by class block, (batch * chunk)-row text GEMMs repeated
    ceil(n_cls / chunk) times, and under ``remat`` each block's forward
    runs again in the backward (counted twice); 0 is one batched pass."""
    gemms = []
    gemms += vit_image_gemms(cfg, batch, n_vpt=0, backward=False, prefix="image")
    # the meta-net MLP forward and backward (dgrad and wgrad): ~1e-5 of the step
    hidden = max(cfg.embed_dim // 16, 1)
    gemms.append(Gemm("meta_net", "proj", batch, cfg.embed_dim, hidden, count=3))
    gemms.append(Gemm("meta_net2", "proj", batch, hidden, cfg.transformer_width, count=3))

    if chunk <= 0 or chunk >= n_cls:
        chunk, n_chunks, tail = n_cls, 1, 0
    else:
        n_chunks, tail = divmod(n_cls, chunk)
    chunked = n_chunks > 1 or tail > 0

    def text_block(rows, mult):
        fwd = text_gemms(cfg, rows, text_len, backward=False, prefix="text")
        dgrad = [g for g in text_gemms(cfg, rows, text_len, backward=True, prefix="text")
                 if g not in fwd]
        fwd_reps = 2 if (remat and chunked) else 1
        return _scale_counts(fwd, mult * fwd_reps) + _scale_counts(dgrad, mult)

    gemms += text_block(batch * chunk, n_chunks)
    if tail:
        gemms += text_block(batch * tail, 1)
    # the logits einsum be,bce->bc forward and its two backward einsums
    gemms.append(Gemm("logits_bmm", "proj", 1, cfg.embed_dim, n_cls, batch=batch, count=3))
    return gemms


def cocoop_step_flops(cfg, batch, n_cls, text_len, chunk=0, remat=True) -> int:
    return total_flops(cocoop_step_gemms(cfg, batch, n_cls, text_len, chunk=chunk, remat=remat))


def total_flops(gemms) -> int:
    return sum(g.flops for g in gemms)


def by_op_class(gemms):
    """{op_class: flops}, for a roofline table."""
    out = {}
    for g in gemms:
        out[g.op_class] = out.get(g.op_class, 0) + g.flops
    return out


def promptsrc_step_flops(cfg, batch, n_cls, text_len, n_vpt=4, teacher="per_step") -> int:
    """True FLOPs (2 per multiply-accumulate) of one PromptSRC step."""
    return total_flops(promptsrc_step_gemms(cfg, batch, n_cls, text_len, n_vpt=n_vpt,
                                            teacher=teacher))
