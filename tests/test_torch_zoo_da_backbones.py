"""The DA slice's backbones against the JAX package's, on the CPU:
alexnet, vgg16, preact_resnet18 and efficientnet_b0 ... b7.

- the same seed draws the JAX package's initial weights and statistics
  (every tensor, bit for bit);
- the eval forward in fp32, at FWD_TOL of the features' largest magnitude;
- the train forward, its new BatchNorm statistics and the input gradient
  of a random cotangent, with JAX's dropout and drop-connect masks handed
  in, within GRAD_TOL; in float32, but for vgg16 and preact_resnet18 in
  float64 on both sides (JAX under ``jax.enable_x64``; its BatchNorm
  computes in float32 inside): in float32 a max-pool window whose two
  largest inputs tie to rounding sends its gradient to either input (vgg16
  at 224x224: 4e-2 of the gradient's largest magnitude apart on 1.9% of
  the pixels), and JAX's float32 train-mode input gradient of
  preact_resnet18 sits 1.5e-2 from the float64 one while the port's sits
  at 2e-6 (measured).  The statistics are compared in units of their
  standard deviation (a batch mean that is zero up to rounding has no
  relative error).  efficientnet_b1 ... b7 share b0's code and differ from
  it in widths, depths and dropout rate, which their weights pin: they are
  held by their weights and eval forward (their JAX train-mode gradients
  compile for 10-30 s each on the CPU);
- a train forward without draws raises, as JAX's without an rng.

vgg16's case (about 50 s: 35 s of it JAX's float64 convolutions) is in
tests/test_torch_zoo_da_vgg16.py, so that the two files run side by side.

Sizes: alexnet and vgg16 at 224x224, batch 1 (JAX's adaptive average pool
takes only inputs whose last feature map divides into 6x6 / 7x7, which is
224 here), preact_resnet18 at 32x32 (its 4x4 pool), the EfficientNets at
64x64 (at 32x32 the last stage is 1x1, and train-mode BatchNorm over 2
values per channel amplifies rounding), batch 2.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fsvlm_tpu_torch.models.backbones import build_backbone
from fsvlm_tpu_torch.models.convert import flatten, load_state, params_tree, state_tree
from fsvlm_tpu_torch.models.draws import Replay

FWD_TOL, GRAD_TOL = 1e-5, 1e-4
EFFICIENTNETS = [f"efficientnet_b{i}" for i in range(8)]
# name: (input size, batch, train check's dtype or None for none)
CASES = {"alexnet": (224, 1, np.float32), "vgg16": (224, 1, np.float64),  # vgg16: its own file
         "preact_resnet18": (32, 2, np.float64), "efficientnet_b0": (64, 2, np.float32),
         **{name: (64, 2, None) for name in EFFICIENTNETS[1:]}}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def rel(port, ref):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    return float(np.abs(port - ref).max(initial=0.0)) / max(float(np.abs(ref).max(initial=0.0)),
                                                            1e-30)


def jax_draws(jb, name, rng, B, out_shape):
    """The keep masks JAX's train forward draws from ``rng``, in the port's
    order (efficientnet.py:121-187, misc.py:85-121)."""
    if name.startswith("efficientnet"):
        out, n = [], len(jb.blocks)
        for i, (_, _, stride, _, cin, cout) in enumerate(jb.blocks):
            rate = 0.2 * float(i) / n
            if stride == 1 and cin == cout and rate:
                out.append(jax.random.bernoulli(jax.random.fold_in(rng, i), 1.0 - rate,
                                                (B, 1, 1, 1)))
        out.append(jax.random.bernoulli(jax.random.fold_in(rng, 10_000), 1.0 - jb.dropout_rate,
                                        out_shape))
    elif name == "preact_resnet18":
        out = []
    else:
        k1, k2 = jax.random.split(rng)
        out = [jax.random.bernoulli(k1, 0.5, (B, 256 * 6 * 6 if name == "alexnet" else 4096)),
               jax.random.bernoulli(k2, 0.5, (B, 4096))]
    return [np.asarray(m) for m in out]


@pytest.mark.parametrize("name", [n for n in CASES if n != "vgg16"])
def test_backbone_matches_jax(name):
    check_backbone(name)


def check_backbone(name):
    from fsvlm_tpu.models.backbones import build_backbone as jax_build

    size, B, dtype = CASES[name]
    jb, pb = jax_build(name, seed=3), build_backbone(name, seed=3)
    assert pb.out_features == jb.out_features
    ref = flatten(jax.tree.map(np.asarray, jb.params))
    mine = flatten(params_tree(pb))
    assert set(mine) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(mine[k], ref[k], err_msg=f"{name} init {k}")
    state = jax.tree.map(np.asarray, jb.state)
    init = flatten(state_tree(pb.init_state()))
    assert set(init) == set(flatten(state))
    for k, v in flatten(state).items():
        np.testing.assert_array_equal(init[k], v, err_msg=f"{name} init state {k}")

    x = np.random.RandomState(0).randn(B, size, size, 3).astype(np.float32)
    f_eval = jax.jit(lambda p, xx: jb.apply(p, state, xx, train=False)[0])(jb.params, x)
    got, _ = pb(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()), load_state(state, "cpu"))
    assert rel(got.detach(), f_eval) <= FWD_TOL, name

    if dtype is None:
        return
    rng = jax.random.PRNGKey(5)
    g = np.random.RandomState(1).randn(*f_eval.shape).astype(dtype)
    # under x64 bernoulli draws from float64 uniforms: the masks come from
    # the same context as the forward
    with jax.enable_x64(dtype == np.float64):
        masks = jax_draws(jb, name, rng, B, f_eval.shape)
        params, state_x = (jax.tree.map(lambda a: jnp.asarray(a, dtype), t)
                           for t in (jb.params, state))

        @jax.jit
        def train_vjp(p, s, xx, gg):
            (f, ns), vjp = jax.vjp(lambda v: jb.apply(p, s, v, train=True, rng=rng), xx)
            return f, ns, vjp((gg, jax.tree.map(jnp.zeros_like, ns)))[0]

        f_ref, ns_ref, gx_ref = jax.tree.map(np.asarray, train_vjp(
            params, state_x, jnp.asarray(x, dtype), jnp.asarray(g)))
    pbx = pb.to(torch.float64 if dtype == np.float64 else torch.float32)
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).astype(dtype)).requires_grad_(True)
    f_port, ns_port = pbx(xt, jax.tree.map(lambda a: torch.from_numpy(a.astype(dtype)), state),
                          train=True, draws=Replay(masks, "cpu"))
    (gx,) = torch.autograd.grad(f_port, xt, torch.from_numpy(g))
    assert rel(f_port.detach(), f_ref) <= GRAD_TOL, f"{name} train forward"
    assert rel(gx.permute(0, 2, 3, 1), gx_ref) <= GRAD_TOL, f"{name} input gradient"
    new, want = flatten(state_tree(ns_port)), flatten(ns_ref)
    assert set(new) == set(want)
    for k, v in want.items():
        std = np.sqrt(np.abs(want[k[:-4] + "var"])).max() if k.endswith("mean") else np.abs(v).max()
        assert np.abs(new[k] - v).max() <= GRAD_TOL * max(std, 1e-30), f"{name} statistics {k}"


@pytest.mark.parametrize("name", ["alexnet", "efficientnet_b0"])
def test_train_forward_without_draws_raises(name):
    pb = build_backbone(name)
    x = torch.zeros(1, 3, 224 if name == "alexnet" else 64, 224 if name == "alexnet" else 64)
    with pytest.raises(ValueError, match="draws"):
        pb(x, pb.init_state(), train=True)
