"""The port's AutoAugment policies and RandAugment variants against the JAX
package's (fsvlm_tpu/data/autoaugment.py), on the CPU, byte for byte.

- the op table: the same 16 ops with the same magnitude ranges, the same
  signed ops, the same three policies and RandAugment op list;
- every op of ``_OPS`` through ``_apply`` at magnitudes 0-10, on both signs
  of the signed ops (the rng's first draw decides the sign), on images
  drawn by hypothesis (1x1 to 300x300, odd widths), against the PIL op;
- ``auto_augment`` under each policy, ``rand_augment``, ``rand_augment2``
  and ``rand_augment_fixmatch`` over seeded draws: the same image and the
  rng left in the same state (the same draws in the same order).
"""

import random

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from fsvlm_tpu.data import autoaugment as jax_aa
from fsvlm_tpu_torch.data import autoaugment as aa


@st.composite
def images(draw, max_side=300):
    h, w = draw(st.integers(1, max_side)), draw(st.integers(1, max_side))
    rs = np.random.RandomState(draw(st.integers(0, 2**31 - 1)))
    if draw(st.booleans()):
        return rs.randint(0, 256, (h, w, 3)).astype(np.uint8)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([x * 200 // max(w, 1) + 20, y * 180 // max(h, 1) + 30, (x * y) % 256], -1)
    return np.clip(base + rs.randint(-6, 7, (h, w, 3)), 0, 255).astype(np.uint8)


class _FixedRandom(random.Random):
    """A Random whose ``random()`` returns ``first`` once (the sign draw of
    a signed op), then draws as seeded."""

    def __init__(self, seed, first):
        super().__init__(seed)
        self._first = first

    def random(self):
        if self._first is not None:
            v, self._first = self._first, None
            return v
        return super().random()


def test_the_op_table_is_the_jax_packages():
    assert list(aa._OPS) == list(jax_aa._OPS)
    assert {k: v[1:] for k, v in aa._OPS.items()} == {k: v[1:] for k, v in jax_aa._OPS.items()}
    assert aa._SIGNED == jax_aa._SIGNED and aa._RAND_OPS == jax_aa._RAND_OPS
    assert aa._POLICIES == jax_aa._POLICIES and aa._FILL == jax_aa._FILL


@settings(max_examples=12, deadline=None)
@given(img=images(), sign_draw=st.sampled_from([0.25, 0.75]), seed=st.integers(0, 1000))
@pytest.mark.parametrize("name", sorted(jax_aa._OPS))
def test_every_op_at_every_magnitude_matches_jax(name, img, sign_draw, seed):
    for magnitude in range(11):
        r1, r2 = _FixedRandom(seed, sign_draw), _FixedRandom(seed, sign_draw)
        ref = np.asarray(jax_aa._apply(Image.fromarray(img), name, magnitude, r1))
        got = aa._apply(img, name, magnitude, r2)
        assert got.dtype == np.uint8 and got.shape == ref.shape, (name, magnitude)
        np.testing.assert_array_equal(got, ref, err_msg=f"{name} at {magnitude}")
        assert r1.getstate() == r2.getstate()


@pytest.mark.parametrize("which", ["imagenet_policy", "cifar10_policy", "svhn_policy",
                                   "rand_augment", "rand_augment2", "rand_augment_fixmatch"])
def test_policies_and_randaugment_match_jax(which):
    rs = np.random.RandomState(sum(map(ord, which)))
    for trial in range(25):
        h, w = rs.randint(8, 260, 2)
        img = rs.randint(0, 256, (h, w, 3)).astype(np.uint8)
        r1, r2 = random.Random(trial), random.Random(trial)
        if which.endswith("_policy"):
            ref = jax_aa.auto_augment(Image.fromarray(img), which, r1)
            got = aa.auto_augment(img, which, r2)
        elif which == "rand_augment":
            n, m = 1 + trial % 3, trial % 11
            ref = jax_aa.rand_augment(Image.fromarray(img), n, m, r1)
            got = aa.rand_augment(img, n, m, r2)
        else:
            n = 1 + trial % 3
            ref = getattr(jax_aa, which)(Image.fromarray(img), n, r1)
            got = getattr(aa, which)(img, n, r2)
        np.testing.assert_array_equal(got, np.asarray(ref), err_msg=f"{which} trial {trial}")
        assert r1.getstate() == r2.getstate()
