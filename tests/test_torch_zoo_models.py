"""The port's zoo backbones and SimpleNet against the JAX package's, on
the CPU (the ops, heads and generators: tests/test_torch_zoo_ops.py).

- the registry is the JAX package's less the names left for later (the two
  wide ResNets of the SSL slice), which raise KeyError naming ROADMAP A9
  (the DA slice's backbones: test_torch_zoo_da_backbones.py);
- the port draws the JAX package's initial weights from a seed (one name
  of each kind; shapes and counts for resnet101 and a dynamic resnet50);
- features in train and eval mode and the new BatchNorm statistics at
  batch 4 for resnet50 and resnet18_ms_l12 (whose eval mode is resnet18)
  at 64x64, resnet18_efdmix_l1 (64x64) and resnet18_dynamic_ms_l1 (32x32)
  with JAX's mixing draws handed in, and the three digit CNNs (32x32,
  cnn_digit5_m3sda with JAX's dropout mask);
- a torchvision-layout state_dict imports to the same features in both
  packages; SimpleNet with an MLP head, and its "no weights found"
  warning; find_backbone_weights.

NHWC inputs go to JAX, their NCHW views to the port.  Limits: FWD_TOL of
each output's largest magnitude (fp32 convolutions summed in another
order); TRAIN_TOL in train mode.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fsvlm_tpu_torch.models import draws as draws_mod
from fsvlm_tpu_torch.models.backbones import BACKBONE_REGISTRY, UNPORTED, build_backbone
from fsvlm_tpu_torch.models.convert import load_state, params_tree, state_tree

FWD_TOL = 1e-5
# train mode: BatchNorm over the batch's statistics divides rounding by their
# spread, which at batch 4 and a 2x2 last stage is small (measured: 1.4e-4,
# resnet50's features)
TRAIN_TOL = 5e-4


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


# ---------------------------------------------------------------- backbones

def test_registry_is_the_jax_one_less_the_names_left_for_later():
    from fsvlm_tpu.models.backbones import BACKBONE_REGISTRY as JAX_REGISTRY

    jax_names = set(JAX_REGISTRY.registered_names())
    assert set(BACKBONE_REGISTRY.registered_names()) == jax_names - set(UNPORTED)
    assert set(UNPORTED) <= jax_names


@pytest.mark.parametrize("name", UNPORTED)
def test_unported_backbones_name_the_roadmap_item(name):
    with pytest.raises(KeyError, match="ROADMAP A9"):
        build_backbone(name)


def _jax_backbone(name, seed=3):
    from fsvlm_tpu.models.backbones import build_backbone as jax_build

    return jax_build(name, seed=seed)


# a style variant draws its plain ResNet's weights: one of each kind
SMALL = ["resnet18", "resnet34", "resnet50", "resnet18_ms_l12", "resnet18_dynamic_ms_l1",
         "cnn_digitsdg", "cnn_digitsingle", "cnn_digit5_m3sda"]
DEEP = ["resnet101", "resnet50_dynamic_ms_l12"]


@pytest.mark.parametrize("name", SMALL + DEEP)
def test_initial_weights_are_the_jax_ones(name):
    """The same seed draws the JAX package's weights; the deep ResNets are
    held by shapes and counts alone."""
    jb, pb = _jax_backbone(name), build_backbone(name, seed=3)
    ref = jax.tree.map(np.asarray, {k: v for k, v in jb.params.items()})
    mine = params_tree(pb)
    if name in DEEP:
        def shapes(t, prefix=""):
            out = {}
            for k, v in t.items():
                if isinstance(v, dict):
                    out.update(shapes(v, f"{prefix}{k}/"))
                elif hasattr(v, "shape") and k != "groups":
                    out[prefix + k] = tuple(v.shape)
            return out

        assert shapes(mine) == shapes(ref)
        assert sum(p.numel() for p in pb.parameters()) == sum(
            int(np.prod(s)) for s in shapes(ref).values())
    else:
        close_trees(mine, ref, name, tol=0.0)
    close_trees(state_tree(pb.init_state()), jax.tree.map(np.asarray, jb.state), name, tol=0.0)


def _mix_draws(name, rng, B, n_blocks):
    """JAX's MixStyle/EFDMix draws of a train forward with ``rng``, in the
    port's order (gate, Beta weights, permutation) per mixed stage."""
    if "_ms_" not in name and "_efdmix_" not in name:
        return []
    tag = name.split("_")[-1]
    stages = {"l123": 3, "l12": 2, "l1": 1}[tag]
    per_stage = n_blocks  # blocks per stage: the mix follows the last of each
    out = []
    for stage in range(stages):
        i = stage * per_stage + per_stage - 1
        k_gate, k_lam, k_perm = jax.random.split(jax.random.fold_in(rng, i), 3)
        out += [np.asarray(jax.random.uniform(k_gate)),
                np.asarray(jax.random.beta(k_lam, 0.1, 0.1, (B,))),
                np.asarray(jax.random.permutation(k_perm, B))]
    return out


# resnet18_ms_l12 in eval mode is resnet18
FORWARD = [("resnet50", 64), ("resnet18_ms_l12", 64),
           ("resnet18_efdmix_l1", 64), ("resnet18_dynamic_ms_l1", 32), ("cnn_digitsdg", 32),
           ("cnn_digitsingle", 32), ("cnn_digit5_m3sda", 32)]


@pytest.mark.parametrize("name,size", FORWARD)
def test_features_and_statistics_match_jax(name, size):
    jb, pb = _jax_backbone(name), build_backbone(name, seed=3)
    x = np.random.RandomState(0).randn(4, size, size, 3).astype(np.float32)
    state = jax.tree.map(np.asarray, jb.state)
    if "dynamic" in name:  # its params hold the grouped conv's int, static under jit
        def apply(s, x, train, rng=None):
            return jb.apply(jb.params, s, x, train=train, rng=rng)
    else:
        fn = jax.jit(jb.apply, static_argnames="train")

        def apply(s, x, train, rng=None):
            return fn(jb.params, s, x, train=train, rng=rng)
    f_eval, _ = apply(state, jnp.asarray(x), train=False)
    got, _ = pb(nchw(x), load_state(state, "cpu"), train=False)
    close(got.detach(), f_eval, f"{name} eval")
    # train mode: batch statistics, new running statistics, and the mixing
    # draws of the first rng that mixes at some stage (gate <= p), or the
    # dropout mask
    for seed in range(100):
        rng = jax.random.PRNGKey(seed)
        draws = _mix_draws(name, rng, 4, 2)
        if not draws or any(float(g) <= 0.5 for g in draws[0::3]):
            break
    if name == "cnn_digit5_m3sda":
        draws = [np.asarray(jax.random.bernoulli(rng, 0.5, (4, 3072)))]
    f_train, ns = apply(state, jnp.asarray(x), train=True, rng=rng)
    got, pns = pb(nchw(x), load_state(state, "cpu"), train=True,
                  draws=draws_mod.Replay(draws, "cpu"))
    close(got.detach(), f_train, f"{name} train", TRAIN_TOL)
    close_trees(state_tree(pns), jax.tree.map(np.asarray, ns), f"{name} new statistics",
                TRAIN_TOL)


def test_style_variant_needs_draws_in_train_mode():
    pb = build_backbone("resnet18_ms_l1")
    x = torch.zeros(2, 3, 32, 32)
    with pytest.raises(ValueError, match="needs draws"):
        pb(x, pb.init_state(), train=True)
    pb(x, pb.init_state(), train=False)


def _torchvision_sd(bb, seed=0):
    """A torchvision-layout resnet state_dict with random entries."""
    rng = np.random.RandomState(seed)
    sd = {}

    def conv(name, w):
        sd[name + ".weight"] = torch.from_numpy(rng.randn(*w.shape).astype(np.float32) * 0.1)

    def bn(name, c):
        for k, lo in (("weight", 0.5), ("bias", -0.2), ("running_mean", -0.3),
                      ("running_var", 0.5)):
            sd[f"{name}.{k}"] = torch.from_numpy(rng.uniform(lo, lo + 1, c).astype(np.float32))

    conv("conv1", bb.conv1.w)
    bn("bn1", 64)
    for key in bb.block_names:
        stage, b = key.split("_")
        blk = getattr(bb, key)
        for c in ("conv1", "conv2", "conv3"):
            if hasattr(blk, c):
                conv(f"{stage}.{b}.{c}", getattr(blk, c).w)
                bn(f"{stage}.{b}.bn{c[-1]}", getattr(blk, c).w.shape[0])
        if blk.has_down:
            conv(f"{stage}.{b}.downsample.0", blk.down_conv.w)
            bn(f"{stage}.{b}.downsample.1", blk.down_conv.w.shape[0])
    return sd


@pytest.mark.parametrize("name", ["resnet50"])
def test_torchvision_state_dict_imports_to_the_same_features(name):
    from fsvlm_tpu.models.backbones.resnet import load_torch_state_dict as jax_load

    from fsvlm_tpu_torch.models.backbones.resnet import load_torch_state_dict

    jb, pb = _jax_backbone(name), build_backbone(name, seed=3)
    sd = _torchvision_sd(pb)
    jp, js = jax_load(jb, sd)
    ps = load_torch_state_dict(pb, sd)
    close_trees(params_tree(pb), jax.tree.map(np.asarray, jp), name, tol=0.0)
    x = np.random.RandomState(1).randn(2, 64, 64, 3).astype(np.float32)
    ref, _ = jax.jit(jb.apply, static_argnames="train")(jp, js, jnp.asarray(x), train=False)
    got, _ = pb(nchw(x), ps, train=False)
    close(got.detach(), ref, f"{name} imported")


def _zoo_cfg(**kw):
    from fsvlm_tpu.config import get_cfg_default

    from fsvlm_tpu_torch.config import get_cfg_base

    jc, pc = get_cfg_default(), get_cfg_base()
    for k, v in dict({"VERBOSE": False, "MODEL.BACKBONE.NAME": "cnn_digitsdg"}, **kw).items():
        node = jc
        *parents, leaf = k.split(".")
        for p in parents:
            node = node[p]
        node[leaf] = v
        pc.merge_from_list([k, v])
    return jc, pc


def test_simple_net_with_head_matches_jax(capsys):
    from fsvlm_tpu.models.simple_net import SimpleNet as JaxSimpleNet

    from fsvlm_tpu_torch.models.simple_net import SimpleNet

    jc, pc = _zoo_cfg(**{"MODEL.HEAD.NAME": "mlp", "MODEL.HEAD.HIDDEN_LAYERS": (64, 32)})
    jn, pn = JaxSimpleNet(jc, jc.MODEL, 5, seed=4), SimpleNet(pc, pc.MODEL, 5, seed=4)
    assert "no weights found" in capsys.readouterr().out  # PRETRAINED defaults to True
    close_trees(params_tree(pn), jax.tree.map(np.asarray, jn.params), "SimpleNet", tol=0.0)
    x = np.random.RandomState(2).randn(6, 32, 32, 3).astype(np.float32)
    for train in (False, True):
        (lj, fj), sj = jn.apply(jn.params, jn.state, jnp.asarray(x), train=train,
                                return_feature=True)
        (lp, fp), sp = pn(nchw(x), load_state(jn.state, "cpu"), train=train, return_feature=True)
        tol = TRAIN_TOL if train else FWD_TOL
        close(lp.detach(), lj, f"logits train={train}", tol)
        close(fp.detach(), fj, f"features train={train}", tol)
        close_trees(state_tree(sp), jax.tree.map(np.asarray, sj), f"state train={train}", tol)


def test_find_backbone_weights(tmp_path, monkeypatch):
    from fsvlm_tpu_torch.models.simple_net import find_backbone_weights

    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.setenv("FSVLM_BACKBONE_WEIGHTS", str(tmp_path))
    assert find_backbone_weights("resnet18") is None
    (tmp_path / "resnet18-x.pth").write_bytes(b"")
    assert find_backbone_weights("resnet18") == str(tmp_path / "resnet18-x.pth")
