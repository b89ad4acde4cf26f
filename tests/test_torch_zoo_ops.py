"""The port's zoo ops, heads and generators against the JAX package's, on
the CPU: MixStyle and EFDMix (random and crossdomain partners, ReLU ties),
MMD, Sinkhorn, the energy distance, label-smoothed CE, TransNorm, DSBN,
the dynamic conv, the MLP head with dropout, the FCN and FCN-STN
generators (the STN's new BatchNorm statistics; its affine grid sample
and the gradient through theta), the distances and the zoo's small ops,
each against its JAX function on the same numpy-seeded inputs with JAX's
draws handed in; the device Beta sampler's moments.

NHWC inputs go to JAX, their NCHW views to the port.  Limit: FWD_TOL of
each output's largest magnitude unless stated.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fsvlm_tpu_torch.models import draws as draws_mod
from fsvlm_tpu_torch.models import modeling_ops as P
from fsvlm_tpu_torch.models.convert import flatten, load_params, load_state, params_tree, state_tree

FWD_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def close(port, ref, what, tol=FWD_TOL):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    assert port.shape == ref.shape, (what, port.shape, ref.shape)
    scale = max(float(np.abs(ref).max(initial=0.0)), 1e-30)
    err = float(np.abs(port - ref).max(initial=0.0)) / scale
    assert err <= tol, f"{what}: {err:.3g} of the largest magnitude"


def close_trees(port, ref, what, tol=FWD_TOL):
    def flat(t, prefix=""):
        out = {}
        for k, v in t.items():
            if isinstance(v, dict):
                out.update(flat(v, f"{prefix}{k}/"))
            elif hasattr(v, "shape") and k != "groups":  # the dynamic conv's int
                out[prefix + k] = np.asarray(v)
        return out

    p, r = flat(port), flat(ref)
    assert set(p) == set(r), (what, sorted(set(p) ^ set(r))[:6])
    for k in r:
        close(p[k], r[k], f"{what} {k}", tol)


# ---------------------------------------------------------------------- ops

@pytest.mark.parametrize("fn", ["mixstyle", "efdmix"])
@pytest.mark.parametrize("mix", ["random", "crossdomain"])
def test_style_mixing_matches_jax(fn, mix):
    from fsvlm_tpu.models import modeling_ops as J

    x = np.maximum(np.random.RandomState(3).randn(6, 5, 5, 4), 0).astype(np.float32)  # ReLU ties
    B = x.shape[0]
    key = jax.random.PRNGKey(5)
    k_gate, k_lam, k_perm = jax.random.split(key, 3)
    draws = [np.asarray(jax.random.uniform(k_gate)),
             np.asarray(jax.random.beta(k_lam, 0.3, 0.3, (B,)))]
    if mix == "random":
        draws.append(np.asarray(jax.random.permutation(k_perm, B)))
    else:
        k1, k2 = jax.random.split(k_perm)
        draws += [np.asarray(jax.random.permutation(k1, B // 2)),
                  np.asarray(jax.random.permutation(k2, B - B // 2))]
    ref = getattr(J, fn)(key, jnp.asarray(x), p=1.0, alpha=0.3, mix=mix)
    got = getattr(P, fn)(draws_mod.Replay(draws, "cpu"), nchw(x), p=1.0, alpha=0.3, mix=mix)
    close(nhwc(got), ref, f"{fn} {mix}")


def test_losses_and_distances_match_jax():
    from fsvlm_tpu.engine import distance as JD
    from fsvlm_tpu.models import modeling_ops as J

    from fsvlm_tpu_torch.engine import distance as PD

    rng = np.random.RandomState(4)
    x, y = rng.randn(8, 16).astype(np.float32), rng.randn(8, 16).astype(np.float32)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    for kernel in ("linear", "poly", "rbf"):
        for norm in (False, True):
            close(P.maximum_mean_discrepancy(tx, ty, kernel, norm),
                  J.maximum_mean_discrepancy(x, y, kernel, norm), f"mmd {kernel} {norm}", 1e-4)
    for metric in ("cosine",):
        close(P.sinkhorn_divergence(tx, ty, metric, eps=0.1),
              J.sinkhorn_divergence(x, y, metric, eps=0.1), f"sinkhorn {metric}", 1e-4)
        close(P.minibatch_energy_distance(tx, ty, metric, eps=0.1),
              J.minibatch_energy_distance(x, y, dist_metric=metric, eps=0.1),
              f"energy {metric}", 1e-4)
    for metric in ("euclidean", "euclidean_squared", "cosine"):
        close(PD.compute_distance_matrix(tx, ty, metric),
              JD.compute_distance_matrix(x, y, metric), metric)
    labels = rng.randint(0, 16, 8)
    for red in ("mean", "sum", "none"):
        close(P.cross_entropy_smooth(tx, torch.from_numpy(labels), 0.1, red),
              J.cross_entropy_smooth(x, labels, 0.1, red), f"ce {red}")


def test_normalizers_match_jax():
    from fsvlm_tpu.models import modeling_ops as J

    rng = np.random.RandomState(5)
    x = rng.randn(8, 4, 4, 6).astype(np.float32) * 2 + 1
    jp, js = J.transnorm_init(6)
    pp, ps = P.transnorm_init(6)
    for train in (True, False):
        ref, jns = J.transnorm_apply(jnp.asarray(x), jp, js, train)
        got, pns = P.transnorm_apply(nchw(x), pp, ps, train)
        close(nhwc(got), ref, f"transnorm {train}")
        close_trees(state_tree(pns), jax.tree.map(np.asarray, jns), f"transnorm {train}")
        js, ps = jns, pns
    jp, js = jax.tree.map(jnp.asarray, J.dsbn_init(6, 3))
    pp, ps = P.dsbn_init(6, 3)
    for dom, train in ((1, True), (2, True), (1, False)):
        ref, jns = J.dsbn_apply(jnp.asarray(x), jp, js, dom, train)
        got, pns = P.dsbn_apply(nchw(x), pp, ps, torch.tensor(dom), train)
        close(nhwc(got), ref, f"dsbn {dom} {train}")
        close_trees(state_tree(pns), jax.tree.map(np.asarray, jns), f"dsbn {dom}")
        js, ps = jns, pns


def test_dynamic_conv_matches_jax():
    from fsvlm_tpu.models import modeling_ops as J

    jp = J.conv2d_dynamic_init(np.random.RandomState(6), 8, 16, 3, squeeze=4,
                               attention_in_channels=8)
    pc = P.Conv2dDynamic(np.random.RandomState(6), 8, 16, 3, squeeze=4, attention_in_channels=8)
    close_trees(params_tree(pc), jax.tree.map(np.asarray, jp), "dynamic conv init", tol=0.0)
    x = np.random.RandomState(7).randn(3, 9, 9, 8).astype(np.float32)
    for stride in (1, 2):
        ref = J.conv2d_dynamic_apply(jnp.asarray(x), jp, stride=stride)
        close(nhwc(P.conv2d_dynamic_apply(nchw(x), pc, stride=stride)), ref, f"stride {stride}")


def test_mlp_head_matches_jax():
    from fsvlm_tpu.models.heads import build_head as jax_head

    from fsvlm_tpu_torch.models.heads import build_head

    kw = dict(in_features=16, hidden_layers=[12, 8], activation="leaky_relu", dropout=0.25,
              seed=2)
    jh, ph = jax_head("mlp", **kw), build_head("mlp", **kw)
    close_trees(params_tree(ph), jax.tree.map(np.asarray, jh.params), "head", tol=0.0)
    x = np.random.RandomState(8).randn(6, 16).astype(np.float32)
    rng = jax.random.PRNGKey(9)
    masks = [np.asarray(jax.random.bernoulli(jax.random.fold_in(rng, i), 0.75, (6, w)))
             for i, w in enumerate((12, 8))]
    for train in (False, True):
        ref, jns = jh.apply(jh.params, jh.state, jnp.asarray(x), train=train, rng=rng)
        got, pns = ph(torch.from_numpy(x), load_state(jh.state, "cpu"), train=train,
                      draws=draws_mod.Replay(masks, "cpu"))
        close(got.detach(), ref, f"head train={train}")
        close_trees(state_tree(pns), jax.tree.map(np.asarray, jns), "head state")


@pytest.mark.parametrize("arch", ["fcn_3x32_gctx", "fcn_3x64_gctx", "fcn_3x32_gctx_stn"])
def test_generators_match_jax(arch):
    from fsvlm_tpu.models.networks import build_network as jax_network

    from fsvlm_tpu_torch.models.networks import build_network

    jn, pn = jax_network(arch, seed=29), build_network(arch, seed=29)
    params = jax.tree.map(np.asarray, jn.params)
    close_trees(params_tree(pn), params, arch, tol=0.0)
    rng = np.random.RandomState(10)
    if "stn" in arch:  # move LocNet's fc off its identity init, so that theta depends on x
        params["loc"]["fc"]["w"] = rng.randn(*params["loc"]["fc"]["w"].shape).astype(
            np.float32) * 0.01
        load_params(pn, params)
    x = rng.randn(4, 32, 32, 3).astype(np.float32)
    g = rng.randn(4, 32, 32, 3).astype(np.float32)
    stateful = jax.jit(lambda p, s, x, train: jn.apply_stateful(p, s, x, lmda=0.3, train=train),
                       static_argnames="train")
    for train in (False, True):
        ref, jns = stateful(params, jn.state, jnp.asarray(x), train)
        got, pns = pn(nchw(x), load_state(jn.state, "cpu"), lmda=0.3, train=train)
        close(nhwc(got), ref, f"{arch} train={train}")
        close_trees(state_tree(pns), jax.tree.map(np.asarray, jns), f"{arch} state")
    if "stn" not in arch:  # the FCN's weight gradients (the STN's: warp below)
        ref = jax.jit(jax.grad(lambda p: (jn.apply(p, jnp.asarray(x), lmda=0.3) * g).sum()))(
            params)
        xp = pn.perturb(nchw(x), 0.3)
        names = [n for n, _ in pn.named_parameters()]
        grads = torch.autograd.grad((xp * nchw(g)).sum(), list(pn.parameters()))
        close_trees(params_tree(pn, dict(zip(names, grads))), jax.tree.map(np.asarray, ref),
                    f"{arch} grads", 1e-4)


def test_affine_grid_sample_and_its_theta_gradient_match_jax():
    from fsvlm_tpu.models.networks import _affine_grid_sample

    from fsvlm_tpu_torch.models.networks import affine_grid_sample

    rng = np.random.RandomState(11)
    x = rng.randn(3, 16, 20, 3).astype(np.float32)
    g = rng.randn(3, 16, 20, 3).astype(np.float32)
    theta = (np.tile(np.array([[0.76, 0.1, 0.05], [-0.2, 0.9, 0.0]], np.float32), (3, 1, 1))
             + rng.randn(3, 2, 3).astype(np.float32) * 0.05)
    ref = _affine_grid_sample(jnp.asarray(x), jnp.asarray(theta))
    t = torch.from_numpy(theta).requires_grad_(True)
    got = affine_grid_sample(nchw(x), t)
    close(nhwc(got), ref, "warp")
    (gt,) = torch.autograd.grad((got * nchw(g)).sum(), t)
    gj = jax.jit(jax.grad(lambda th: (_affine_grid_sample(jnp.asarray(x), th) * g).sum()))(
        jnp.asarray(theta))
    close(gt.numpy(), gj, "d warp / d theta", 1e-4)


def test_zoo_ops_match_jax():
    from fsvlm_tpu.trainers.zoo import ops as J

    from fsvlm_tpu_torch.trainers.zoo import ops as Z

    for n in (0, 3, 10, 40):
        for ramp in ("sigmoid_rampup", "linear_rampup"):
            close(getattr(Z, ramp)(n, 20), getattr(J, ramp)(jnp.asarray(n), 20), ramp, 1e-6)
    rng = np.random.RandomState(12)
    p = np.abs(rng.randn(5, 4)).astype(np.float32)
    p /= p.sum(1, keepdims=True)
    close(Z.sharpen_prob(torch.from_numpy(p), 2.0), J.sharpen_prob(p, 2.0), "sharpen")
    labels = rng.randint(0, 4, 5)
    close(Z.create_onehot(torch.from_numpy(labels), 4), J.create_onehot(labels, 4), "onehot", 0)
    logits, targets = rng.randn(5, 3).astype(np.float32), rng.rand(5, 3).astype(np.float32)
    valid = np.array([True, True, False, True, True])
    close(Z.bce_logits(torch.from_numpy(logits), torch.from_numpy(targets),
                       torch.from_numpy(valid)), J.bce_logits(logits, targets, valid), "bce")
    x1, x2 = rng.randn(5, 2, 2, 3).astype(np.float32), rng.randn(5, 2, 2, 3).astype(np.float32)
    key = jax.random.PRNGKey(13)
    rx, ry = J.mixup_pair(key, x1, x2, p, p[::-1], 0.75)
    lam = [np.asarray(jax.random.beta(key, 0.75, 0.75, shape=(5,)))]
    gx, gy = Z.mixup_pair(draws_mod.Replay(lam, "cpu"), torch.from_numpy(x1),
                          torch.from_numpy(x2), torch.from_numpy(p),
                          torch.from_numpy(p[::-1].copy()), 0.75)
    close(gx, rx, "mixup x")
    close(gy, ry, "mixup y")
    t, s = {"a": rng.randn(3).astype(np.float32)}, {"a": rng.randn(3).astype(np.float32)}
    close(Z.ema_update({"a": torch.from_numpy(s["a"])}, {"a": torch.from_numpy(t["a"])},
                       0.9)["a"], J.ema_update(s, t, 0.9)["a"], "ema")
    # the critic (DANN's, ADDA's): JAX's mlp_head_init + a linear "out"
    from fsvlm_tpu.models.backbones.common import linear_apply, linear_init

    rng_j = np.random.RandomState(14)
    jp, js, jout = J.mlp_head_init(rng_j, 6, [5, 4])
    jp["out"] = linear_init(rng_j, jout, 1)
    critic = Z.Critic(np.random.RandomState(14), 6, [5, 4])
    assert jout == 4
    for k, v in flatten(params_tree(critic)).items():
        np.testing.assert_array_equal(v, flatten(jp)[k], err_msg=k)
    f = rng.randn(7, 6).astype(np.float32)
    h, jns = J.mlp_head_apply(jnp.asarray(f), jp, js, True, 2)
    got, pns = critic(torch.from_numpy(f), load_state(js, "cpu"), True)
    close(got.detach(), linear_apply(h, jp["out"]), "critic")
    for k in jns:
        close(pns[k]["var"], jns[k]["var"], f"critic {k} statistics")
    jw = J.prototypes_init(np.random.RandomState(15), 6, 3)
    proto = Z.Prototypes(np.random.RandomState(15), 6, 3)
    np.testing.assert_array_equal(params_tree(proto)["w"], jw["w"])
    close(proto(torch.from_numpy(f)).detach(), J.prototypes_apply(f, jw), "prototypes")
    ft = torch.from_numpy(f).requires_grad_(True)
    (gr,) = torch.autograd.grad((Z.grad_reverse(ft, 0.5) * 2).sum(), ft)
    np.testing.assert_array_equal(gr.numpy(), np.full_like(f, -1.0))


def test_draws_are_finite_and_in_range():
    """The device sampler's Beta at MixStyle's alpha 0.1 (mass at 0 and 1)
    and DomainMix's 1.0, its permutation and categorical."""
    d = draws_mod.Draws(torch.Generator().manual_seed(0))
    for a in (0.1, 1.0, 2.0):
        lam = d.beta(a, a, (20000,))
        assert torch.isfinite(lam).all() and (lam >= 0).all() and (lam <= 1).all()
        # Beta(a, a): mean 1/2, variance 1 / (4 (2a + 1))
        assert abs(float(lam.mean()) - 0.5) < 0.01
        assert abs(float(lam.var()) - 1 / (4 * (2 * a + 1))) < 0.01
    assert sorted(d.permutation(9).tolist()) == list(range(9))
    w = torch.tensor([[0.0, 1.0, 1.0], [1.0, 0.0, 0.0]])
    picks = d.categorical(torch.log(w + 1e-9).expand(500, 2, 3).reshape(1000, 3))
    assert set(picks[0::2].tolist()) <= {1, 2} and set(picks[1::2].tolist()) == {0}
