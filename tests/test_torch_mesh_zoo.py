"""The Dassl zoo across ranks (fsvlm_tpu_torch/parallel/mesh.py), on the CPU:
two gloo ranks against one rank (tests/test_torch_mesh_zoo_jax.py holds two
ranks against the JAX package's 8-device mesh).

- two ranks (subprocesses, tests/torch_mesh_worker.py; one invocation per
  rank runs every case) against one rank on the same padded global
  batches (9 labeled rows -> 10, 5 unlabeled -> 6: one pad row each),
  2 steps from the seed's state (M3SDA and CDAC: 1, see the worker's
  ONE_STEP), SyntheticDA with cnn_digitsdg at 32x32 and a BatchNorm head:
  every DG and DA trainer (Vanilla, CrossGrad, DDAIG, DomainMix
  crossdomain and random over the global batch, DAELDG, SourceOnly, DANN,
  ADDA and AdaBN from a source checkpoint, MCD, MME, SE, M3SDA, CDAC,
  DAEL), DAELDG and M3SDA also at a block of 3 rows per domain (2 + 2 rows
  on the ranks, one a pad row), and FixMatch on each kind of network that
  draws for its rows: MixStyle random and crossdomain (resnet18_ms_l12),
  EFDMix (resnet18_efdmix_l12, in float64), dropout (cnn_digit5_m3sda) and
  drop-connect (efficientnet_b0), the style mixers at p = 1: each step's
  metrics, the weights with ``extra`` (ADDA's source model, SE's teacher)
  and the BatchNorm statistics, per case; the gathered ``test()``
  predictions of the ensembles (DAELDG, M3SDA, DAEL);
- one rank under a gloo process group bit-equal to no process group;
- the rules alone in float64 (a padded per-domain block's BatchNorm, its
  draws and rows in the global order, FixMatch's [x; u] layout, the global
  moments and pair mean with their gradients) on two ranks against one.
"""

import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))

from test_torch_mesh import _launch  # noqa: E402

ZOO_CASES = ["vanilla", "crossgrad", "ddaig", "domainmix_crossdomain", "domainmix_random",
             "daeldg", "daeldg_odd", "sourceonly", "dann", "adda", "adabn", "mcd", "mme", "se",
             "m3sda", "m3sda_odd", "cdac", "dael", "fixmatch_mixstyle",
             "fixmatch_mixstyle_crossdomain", "fixmatch_efdmix_f64", "fixmatch_dropout",
             "fixmatch_dropconnect"]
GLOO_ONE = ["daeldg_odd", "m3sda", "cdac", "domainmix_crossdomain", "fixmatch_mixstyle"]
# two ranks against one: each rank sums its rows and the all-reduce adds the
# sums, where one rank sums every row at once.  Limits of
# test_torch_zoo_trainers.py (a metric within METRIC_TOL * (1 + |m|)) and
# test_torch_mesh.py's MESH_TOL for the BatchNorm nets (each tensor within
# rtol 1e-4 + atol 3e-5).  Measured (2 steps, M3SDA and CDAC 1): at most
# 0.20 of the metric limit (FixMatch drop-connect's loss_u, 2.0e-6 apart),
# 0.40 of the weight limit (its block0.dw.w, 1.3e-5) and 0.53 of the
# statistic limit (M3SDA's head BN mean, 3.3e-5); EFDMix in float64 7.5e-15.
METRIC_TOL, RTOL, ATOL = 1e-5, 1e-4, 3e-5


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case on two ranks and on one, and GLOO_ONE on one rank under a
    process group, started together.  Returns their directories."""
    root = tmp_path_factory.mktemp("mesh_zoo")
    dirs = [root / d for d in ("two", "one", "gloo_one", "helpers")]
    for d in dirs:
        d.mkdir()
    cases = ",".join(ZOO_CASES)
    two, one, gloo_one, helpers = dirs
    _launch((cases, 2, 2, two / "{case}.npz"), (cases, 1, 2, one / "{case}.npz"),
            (",".join(GLOO_ONE), "1g", 2, gloo_one / "{case}.npz"),
            ("zoo_helpers", 2, 2, helpers / "two.npz"),
            ("zoo_helpers", 1, 2, helpers / "one.npz")).wait()
    return dirs


def _pair(runs, case, prefix):
    two, one = (dict(np.load(d / f"{case}.npz")) for d in runs[:2])
    assert set(two) == set(one)
    keys = sorted(k for k in one if k.startswith(prefix))
    return two, one, keys


@pytest.mark.parametrize("case", ZOO_CASES)
def test_metrics_match_one_rank(runs, case):
    two, one, keys = _pair(runs, case, "m")
    assert any(k.startswith("m0/") for k in keys)
    for k in keys:
        ref = float(one[k])
        assert abs(float(two[k]) - ref) <= METRIC_TOL * (1 + abs(ref)), (case, k, float(two[k]),
                                                                          ref)


@pytest.mark.parametrize("case", ZOO_CASES)
def test_weights_match_one_rank(runs, case):
    two, one, keys = _pair(runs, case, "p/")
    keys += sorted(k for k in one if k.startswith("e/"))
    assert keys
    for k in keys:
        np.testing.assert_allclose(two[k], one[k], rtol=RTOL, atol=ATOL, err_msg=f"{case} {k}")


@pytest.mark.parametrize("case", ZOO_CASES)
def test_statistics_match_one_rank(runs, case):
    two, one, keys = _pair(runs, case, "s/")
    assert keys
    for k in keys:
        np.testing.assert_allclose(two[k], one[k], rtol=RTOL, atol=ATOL, err_msg=f"{case} {k}")


@pytest.mark.parametrize("case", ["daeldg_odd", "m3sda_odd", "dael"])
def test_gathered_test_predictions_match_one_rank(runs, case):
    """``test()`` after the steps: each rank infers its rows of the test set
    (the ensembles of DAELDG's and DAEL's experts, M3SDA's classifiers) and
    the logits are gathered."""
    two, one, _ = _pair(runs, case, "pred")
    assert len(one["pred"]) > 0
    np.testing.assert_array_equal(two["pred"], one["pred"])


@pytest.mark.parametrize("case", GLOO_ONE)
def test_one_gloo_rank_is_bit_equal_to_no_group(runs, case):
    got = dict(np.load(runs[2] / f"{case}.npz"))
    ref = dict(np.load(runs[1] / f"{case}.npz"))
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=f"{case} {k}")


def test_zoo_rules_on_two_ranks_match_one_process(runs):
    """On one rank each rule is the plain computation (F.batch_norm, the
    mean and variance, the pair mean); two ranks match it to float64's
    rounding, in the global row order."""
    two, one = (dict(np.load(runs[3] / f"{n}.npz")) for n in ("two", "one"))
    assert set(two) == set(one)
    for k in one:
        np.testing.assert_allclose(two[k], one[k], rtol=1e-12, atol=1e-12, err_msg=k)
    np.testing.assert_array_equal(one["drawn"], np.arange(7) * 1.5)
    np.testing.assert_array_equal(two["xu_rows"], np.arange(10))
    assert two["bn_y"].shape == (7, 3, 2, 2)
