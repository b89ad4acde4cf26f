"""Every CLIP trainer across ranks (fsvlm_tpu_torch/parallel/mesh.py), on the
CPU: two gloo ranks against one rank (tests/test_torch_mesh_clip_jax.py
holds two ranks against the JAX package's 8-device mesh).

- two ranks (subprocesses, tests/torch_mesh_worker.py; one invocation per
  rank runs every case) against one rank on the same padded batches (9
  rows -> 10: one pad row), test-tiny on Synthetic, 2 steps: PromptSRC
  with CACHED_TEACHER (and its gathered test()) and with SIMCLR_ALPHA
  (NT-Xent over the gathered views), IVLP with mixup over the global batch
  and KD, IVLP's and CoOp's NT-Xent, MaPLe, CoCoOp, LinearProbeCLIP, LoRA
  with dropout (the image tower's masks drawn for the global batch and
  sliced: the one-rank run draws the same global masks), PLIP grad, svd
  and spectral_norm, ZeroshotCLIP/2 (the gathered test()), and PromptSRC
  on 16 rows with no "valid" (every row mean still the global batch's):
  metrics and weights within MESH_TOL, and rank 0 alone writing LoRA's
  checkpoint;
- the helpers alone: ``gather_rows_grad``'s and ``all_reduce_sum``'s
  backward against one process's autograd of the same global function,
  and ``replicated_term``'s metric and gradient summed over the ranks
  against the one-rank value;
- fused epochs on two ranks (the CPU's eager fused path over each rank's
  columns of the schedule, padded) against the same epochs step by step,
  bit for bit: PromptSRC, and IVLP with mixup and KD;
- the DG and DA zoo trainers still raise ValueError naming A8 at two ranks.
"""

import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))

import torch_mesh_worker as w  # noqa: E402
from test_torch_mesh import _launch, _wait  # noqa: E402

# two ranks against one on the same padded batches: each rank sums its
# rows, and the all-reduce adds the two sums, where one rank sums all rows
# at once; 2 steps at LR 0.05 carry that rounding to at most 1.43e-6 on a
# loss, 9.8e-7 on a weight (measured), so (rtol 1e-5, atol 2e-6) for all
CLIP_CASES = ["promptsrc_cached", "promptsrc_simclr", "ivlp_mixup_kd", "ivlp_simclr",
              "coop_simclr", "maple", "cocoop", "linear_probe", "lora_dropout", "plip_grad",
              "plip_svd", "plip_spectral_norm", "zeroshot", "zeroshot2", "promptsrc_novalid"]
MESH_TOL = (1e-5, 2e-6)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case on two ranks and on one, started together.  Returns
    (two-rank dir, one-rank dir)."""
    root = tmp_path_factory.mktemp("mesh_clip")
    cases = ",".join(CLIP_CASES + ["helpers", "fused"])
    two, one = root / "two", root / "one"
    two.mkdir()
    one.mkdir()
    procs = _launch(cases, 2, 2, two / "{case}.npz") + _launch(cases, 1, 2, one / "{case}.npz")
    _wait(procs)
    return two, one


@pytest.mark.parametrize("case", CLIP_CASES)
def test_two_ranks_match_one_rank(runs, case):
    two, one = runs
    a, b = dict(np.load(two / f"{case}.npz")), dict(np.load(one / f"{case}.npz"))
    assert set(a) == set(b) and any(k.startswith("m1/") for k in a)
    assert any(k.startswith("p/") for k in a) == (not case.startswith("zeroshot"))
    rtol, atol = MESH_TOL
    for k in sorted(b):
        np.testing.assert_allclose(a[k], b[k], rtol=rtol, atol=atol, err_msg=f"{case} {k}")
    if case == "lora_dropout":  # rank 0 alone writes lora/*.pkl
        lora = ("save0", "Synthetic", "test-tiny", "lora", "best.pkl")
        assert os.path.exists(os.path.join(two, *lora)) and os.path.exists(os.path.join(one, *lora))
        assert not os.path.exists(two / "save1")


def test_mesh_helpers_match_one_process(runs):
    """The worker's functions on rows 0-2 and 3-5 of one seeded X (6, 3):
    sum over the ranks' rows i of sum_j sin(x_i . x_j) through
    ``gather_rows_grad``; sum over the ranks of (S * x_r) with S the
    ``all_reduce_sum`` of the x_r; a replicated term of P."""
    two, one = runs
    got, ref1 = dict(np.load(two / "helpers.npz")), dict(np.load(one / "helpers.npz"))
    rng = np.random.RandomState(5)
    X = torch.from_numpy(rng.randn(6, 3)).requires_grad_()
    P = torch.from_numpy(rng.randn(4, 3)).requires_grad_()
    g_gather, = torch.autograd.grad((X @ X.T).sin().sum(), X)
    S = X.reshape(2, 3, 3).sum(0)
    g_sum, = torch.autograd.grad((S * S).sum(), X)
    term = (P.sin() ** 2).sum()
    g_term, = torch.autograd.grad(term, P)
    np.testing.assert_allclose(got["gather"], g_gather.numpy(), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got["sum"], g_sum.numpy(), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(ref1["gather"], g_gather.numpy(), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(ref1["sum"], 2 * X.detach().numpy(), rtol=0, atol=0)  # S = x
    for r in (got, ref1):  # half the term on each of two ranks, summed: the term
        np.testing.assert_allclose(r["term"], term.item(), rtol=1e-15, atol=0)
        np.testing.assert_allclose(r["term_grad"], g_term.numpy(), rtol=1e-15, atol=0)


@pytest.mark.parametrize("key", ["PROMPTSRC", "IVLP"])
def test_fused_epochs_on_two_ranks_match_step_by_step(runs, key):
    """PromptSRC, and IVLP with mixup (its permutation drawn for the global
    batch at the fused step) and KD, on a 12-image cache, batch 3 (each
    rank 2 columns of the schedule, one of them padded): 2 epochs fused
    and 2 step by step on two ranks, bit for bit; on one rank likewise."""
    for d, cols in zip(runs, (2, 3)):
        r = {k[len(key) + 1:]: v for k, v in np.load(d / "fused.npz").items()
             if k.startswith(key + "/")}
        assert r["on/fuses"] and not r["off/fuses"] and int(r["on/batch"]) == cols
        assert int(r["on/eager_steps"]) == 8 and int(r["off/eager_steps"]) == 0
        assert int(r["on/count"]) == int(r["off/count"]) == 8
        on = {k[3:]: v for k, v in r.items() if k.startswith("on/m") or k.startswith("on/p/")}
        off = {k[4:]: v for k, v in r.items() if k.startswith("off/m") or k.startswith("off/p/")}
        assert on.keys() == off.keys() and len(on) > 8
        for k in on:
            np.testing.assert_array_equal(on[k], off[k], err_msg=k)


# the DG and DA zoo trainers: their per-domain and paired terms are A8's
# last part
ZOO_REFUSING = ("Vanilla", "CrossGrad", "DDAIG", "DomainMix", "DAELDG", "SourceOnly", "DANN",
                "ADDA", "AdaBN", "MCD", "MME", "SE", "M3SDA", "CDAC", "DAEL")


@pytest.mark.parametrize("name", ZOO_REFUSING)
def test_dg_and_da_trainers_refuse_two_ranks(tmp_path, monkeypatch, name):
    from fsvlm_tpu_torch import trainers  # noqa: F401  (registers them)
    from fsvlm_tpu_torch.engine.trainer import TRAINER_REGISTRY, build_trainer
    from fsvlm_tpu_torch.parallel import mesh
    from test_torch_zoo_da_trainers import _cfgs

    assert not TRAINER_REGISTRY.get(name).data_parallel
    _, cfg = _cfgs(tmp_path, name, {})
    monkeypatch.setattr(mesh, "world_size", lambda: 2)
    with pytest.raises(ValueError, match="ROADMAP A8"):
        build_trainer(cfg, device="cpu")
