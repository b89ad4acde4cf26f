"""Prompt assembly as one scatter-einsum (counterpart of
fsvlm_tpu.trainers.prompts).

``build_prompt_context`` is a numpy copy: a frozen base embedding (ctx slots
zeroed, rows pre-permuted per class-token position) and a one-hot scatter,
so that assembling the prompts is

    prompts = base + einsum('cpj,jd->cpd', scatter, ctx)      (unified ctx)
    prompts = base + einsum('cpj,cjd->cpd', scatter, ctx)     (CSC)

EOT positions are permutation-invariant, so eot_idx = tokenized.argmax(-1)
as in the reference (trainers/coop.py:204).
"""

import numpy as np
import torch

from ..models.clip.tokenizer import get_tokenizer, tokenize


def build_prompt_context(
    token_embedding,
    classnames,
    n_ctx,
    ctx_init="",
    class_token_position="end",
    csc=False,
    rng=None,
    context_length=77,
    init_keep_n_ctx=False,
    truncate=False,
):
    """Frozen prompt-assembly arrays + the ctx init value.

    token_embedding: (vocab, D) array (the text tower's, as float32).
    Keys: base_embed (n_cls, L, D) fp32; ctx_scatter (n_cls, L, n_ctx) fp32;
    tokenized (n_cls, L) int32; eot_idx (n_cls,) int32; name_lens;
    init_ctx ((n_ctx, D) or (n_cls, n_ctx, D) when csc).
    """
    tok = get_tokenizer()
    token_embedding = np.asarray(token_embedding, np.float32)
    D = token_embedding.shape[1]
    rng = rng or np.random.RandomState(0)

    if ctx_init:
        ctx_init = ctx_init.replace("_", " ")
        if not init_keep_n_ctx:
            # CoOp semantics: n_ctx follows the init phrase (coop.py:220-228)
            n_ctx = len(ctx_init.split(" "))
        # VLPromptLearner semantics keep cfg's n_ctx and slice the phrase
        # embedding (promptsrc.py:90-98)
        init_ids = tokenize(ctx_init)[0]
        init_ctx = token_embedding[init_ids[1 : 1 + n_ctx]].copy()
        prompt_prefix = ctx_init
    else:
        shape = (len(classnames), n_ctx, D) if csc else (n_ctx, D)
        init_ctx = rng.normal(0.0, 0.02, size=shape).astype(np.float32)
        prompt_prefix = " ".join(["X"] * n_ctx)
    if csc and init_ctx.ndim == 2:
        init_ctx = np.broadcast_to(init_ctx, (len(classnames), n_ctx, D)).copy()

    classnames = [name.replace("_", " ") for name in classnames]
    name_lens = [len(tok.encode(name)) for name in classnames]
    prompts = [prompt_prefix + " " + name + "." for name in classnames]
    tokenized = tokenize(prompts, context_length=context_length)
    embedding = token_embedding[tokenized]  # (n_cls, L, D)

    n_cls, L = tokenized.shape
    base = np.zeros_like(embedding)
    scatter = np.zeros((n_cls, L, n_ctx), np.float32)

    for i in range(n_cls):
        nl = name_lens[i]
        if class_token_position == "end":
            order = [("row", 0)]
            order += [("ctx", j) for j in range(n_ctx)]
            order += [("row", p) for p in range(1 + n_ctx, L)]
        elif class_token_position == "middle":
            half = n_ctx // 2
            order = [("row", 0)]
            order += [("ctx", j) for j in range(half)]
            order += [("row", p) for p in range(1 + n_ctx, 1 + n_ctx + nl)]
            order += [("ctx", j) for j in range(half, n_ctx)]
            order += [("row", p) for p in range(1 + n_ctx + nl, L)]
        elif class_token_position == "front":
            order = [("row", 0)]
            order += [("row", p) for p in range(1 + n_ctx, 1 + n_ctx + nl)]
            order += [("ctx", j) for j in range(n_ctx)]
            order += [("row", p) for p in range(1 + n_ctx + nl, L)]
        else:
            raise ValueError(f"Unknown class_token_position: {class_token_position}")

        assert len(order) == L
        for pos, (kind, idx) in enumerate(order):
            if kind == "row":
                base[i, pos] = embedding[i, idx]
            else:
                scatter[i, pos, idx] = 1.0

    eot_idx = tokenized.argmax(axis=-1).astype(np.int32)
    if truncate:
        # with the causal text mask, positions past the last EOT can never
        # influence a gathered feature: trimming is exact; the kept length is
        # padded to a multiple of 8, as in the JAX package
        L_used = int(eot_idx.max()) + 1
        L_trim = min(L, ((L_used + 7) // 8) * 8)
        base = base[:, :L_trim]
        scatter = scatter[:, :L_trim]
        tokenized = tokenized[:, :L_trim]

    return {
        "base_embed": base,
        "ctx_scatter": scatter,
        "tokenized": tokenized,
        "eot_idx": eot_idx,
        "name_lens": np.asarray(name_lens, np.int32),
        "init_ctx": init_ctx,
        "n_ctx": n_ctx,
        "prompt_prefix": prompt_prefix,
    }


def prompt_tensors(pc, device):
    """A ``build_prompt_context`` result's frozen arrays as tensors on
    ``device``: base_embed, ctx_scatter (fp32) and eot_idx (int64)."""
    return {
        "base_embed": torch.from_numpy(pc["base_embed"]).to(device),
        "ctx_scatter": torch.from_numpy(pc["ctx_scatter"]).to(device),
        "eot_idx": torch.from_numpy(pc["eot_idx"]).long().to(device),
    }


def assemble_prompts(ctx, base_embed, ctx_scatter):
    """prompts = base + scatter @ ctx (unified or class-specific ctx)."""
    ctx = ctx.to(base_embed.dtype)
    if ctx.dim() == 2:
        delta = torch.einsum("cpj,jd->cpd", ctx_scatter, ctx)
    else:
        delta = torch.einsum("cpj,cjd->cpd", ctx_scatter, ctx)
    return base_embed + delta
