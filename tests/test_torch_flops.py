"""The port's ``utils/flops.py`` against ``fsvlm_tpu.utils.flops``, exactly:
every Gemm (name, op class, shape, batch, count) and every total, at the
PromptSRC and CoCoOp step shapes of ViT-B/16, ViT-B/32 and test-tiny, the
teacher per step, cached and int8, CoCoOp batched and class-chunked, with
and without remat, the text tower forward and backward."""

import dataclasses

import pytest

from fsvlm_tpu.models.clip.config import ARCHS as JAX_ARCHS
from fsvlm_tpu.utils import flops as jax_flops
from fsvlm_tpu_torch.models.clip.config import ARCHS
from fsvlm_tpu_torch.utils import flops

CASES = [
    # (function, kwargs): text_len 16 is the tiny recipe's truncated length,
    # 24 PromptSRC's 100-class list, 77 the untruncated context
    ("promptsrc_step_gemms", dict(batch=48, n_cls=100, text_len=24, teacher="per_step")),
    ("promptsrc_step_gemms", dict(batch=48, n_cls=100, text_len=24, teacher="cached")),
    ("promptsrc_step_gemms", dict(batch=4, n_cls=8, text_len=16, n_vpt=2, teacher="int8")),
    ("cocoop_step_gemms", dict(batch=1, n_cls=100, text_len=24)),
    ("cocoop_step_gemms", dict(batch=48, n_cls=170, text_len=24, chunk=85, remat=True)),
    ("cocoop_step_gemms", dict(batch=32, n_cls=100, text_len=77, chunk=30, remat=True)),
    ("cocoop_step_gemms", dict(batch=32, n_cls=100, text_len=77, chunk=30, remat=False)),
    ("text_gemms", dict(n_cls=100, seq_len=77, backward=False)),
    ("text_gemms", dict(n_cls=100, seq_len=24, backward=True)),
    ("vit_image_gemms", dict(batch=100, n_vpt=0, backward=False)),
]


@pytest.mark.parametrize("arch", ["ViT-B/16", "ViT-B/32", "test-tiny"])
@pytest.mark.parametrize("fn,kw", CASES, ids=[f"{fn}-{i}" for i, (fn, _) in enumerate(CASES)])
def test_flops_match_jax(arch, fn, kw):
    ours = getattr(flops, fn)(ARCHS[arch], **kw)
    ref = getattr(jax_flops, fn)(JAX_ARCHS[arch], **kw)
    assert [dataclasses.astuple(g) for g in ours] == [dataclasses.astuple(g) for g in ref]
    assert [g.flops for g in ours] == [g.flops for g in ref]
    assert flops.total_flops(ours) == jax_flops.total_flops(ref) > 0
    assert flops.by_op_class(ours) == jax_flops.by_op_class(ref)
    total = {"promptsrc_step_gemms": "promptsrc_step_flops",
             "cocoop_step_gemms": "cocoop_step_flops"}.get(fn)
    if total:
        assert (getattr(flops, total)(ARCHS[arch], **kw)
                == getattr(jax_flops, total)(JAX_ARCHS[arch], **kw) == flops.total_flops(ours))


def test_unknown_teacher_raises_in_both():
    for mod, archs in ((flops, ARCHS), (jax_flops, JAX_ARCHS)):
        with pytest.raises(ValueError, match="unknown teacher mode"):
            mod.promptsrc_step_gemms(archs["test-tiny"], 4, 8, 16, teacher="none")
