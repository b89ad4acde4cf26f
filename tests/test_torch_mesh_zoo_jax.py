"""Two gloo ranks of the port's zoo trainers against the JAX package's zoo
step on its 8-device CPU mesh (one SPMD step over a padded, sharded global
batch), for the trainers whose terms pair rows, cut the batch into
per-domain blocks or draw for the global batch: DomainMix crossdomain
(the partner drawn over the global batch's domains), DAELDG and M3SDA
(each rank its share of every block), CDAC (the pairwise similarity and
P of this rank's rows against the global batch's) and FixMatch on
resnet18_ms_l12 (MixStyle at p = 1 on both sides, its weights and partners
drawn for the global [x; u] batch).  JAX's draws are handed to the ranks
through ``Replay`` at the global shapes, and each rank keeps its rows.
SyntheticDA with cnn_digitsdg at 32x32 and a BatchNorm head, 16 + 8 rows
(M3SDA 24 + 8: 3 blocks of 8), no mesh pad row; the worker's steps from
the seed's state, at the limits of tests/test_torch_zoo_trainers.py.
"""

import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))

import torch_mesh_worker as w  # noqa: E402
from test_torch_mesh import _launch  # noqa: E402

JAX_CASES = ["domainmix_crossdomain16", "daeldg16", "m3sda24", "cdac16", "fixmatch_mixstyle16"]
JAX_KEY0 = 200  # JAX's step s runs on PRNGKey(JAX_KEY0 + s)


def _key(step):
    import jax

    return jax.random.PRNGKey(JAX_KEY0 + step)


def _jax_draws(case, step, bx):
    """The values that the JAX step draws from its key, in the port's order:
    DomainMix's weight and partners; FixMatch's MixStyle gate, weights and
    partners of each mixed stage, forward by forward ([x; u] weak, x,
    [x; u] strong)."""
    from fsvlm_tpu.trainers.zoo.ops import fwd_keys
    from test_torch_zoo_models import _mix_draws
    from test_torch_zoo_trainers import _jax_draws as domainmix_draws

    if case.startswith("domainmix"):
        return domainmix_draws("DomainMix-crossdomain", _key(step), bx)
    if case.startswith("fixmatch"):
        _, _, bx_n, bu_n = w.CASES[case]
        return [v for k, n in zip(fwd_keys(_key(step), 3), (bx_n + bu_n, bx_n, bx_n + bu_n))
                for v in _mix_draws("resnet18_ms_l12", k, n, 2)]
    return []


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The cases on two ranks with JAX's draws, started here and run beside
    the JAX trainers' builds and compiles.  Returns ``result(case)``."""
    root = tmp_path_factory.mktemp("mesh_zoo_jax")
    draws = root / "draws.npz"
    given = {}
    for case in JAX_CASES:
        for step, (bx, _) in enumerate(w.batches(case, 4)):
            given.update({f"{case}/d{step}/{i}": np.asarray(v)
                          for i, v in enumerate(_jax_draws(case, step, bx))})
    np.savez(draws, **given)
    group = _launch((",".join(JAX_CASES), 2, 2, root / "{case}.npz", draws))

    def result(case):
        group.wait()
        return dict(np.load(root / f"{case}.npz"))

    return result


@pytest.mark.parametrize("case", JAX_CASES)
def test_two_ranks_match_jax_on_eight_devices(two_ranks, tmp_path, case):
    import jax

    from fsvlm_tpu.engine import build_trainer as jax_build_trainer
    from fsvlm_tpu.parallel.mesh import shard_batch
    import fsvlm_tpu.trainers  # noqa: F401
    from fsvlm_tpu_torch.models.convert import flatten
    from test_torch_zoo_da_trainers import _cfgs
    from test_torch_zoo_trainers import METRIC_TOL, _assert_trees

    name, settings, _, bu_n = w.CASES[case]
    jcfg, _ = _cfgs(tmp_path, name, settings)
    jt = jax_build_trainer(jcfg)
    assert jt.mesh.devices.size == 8 and jt.num_classes == 4
    if case.startswith("fixmatch"):
        jt.net.backbone.ms_p = 1.0  # every train forward mixes, as the worker's
    ref = {}
    for step, (bx, bu) in enumerate(w.batches(case, jt.num_classes)):
        jt.params, jt.opt_state, jt.model_state, jt.extra, m = jt._train_step_xu(
            jt.params, jt.opt_state, jt.model_state, jt.extra, shard_batch(bx, jt.mesh),
            shard_batch(bu, jt.mesh) if bu_n else None, _key(step), np.asarray(step, np.int32))
        ref.update({f"m{step}/{k}": float(v) for k, v in m.items()})
    got = two_ranks(case)
    assert {k for k in got if k.startswith("m")} == set(ref)
    for k, v in ref.items():
        assert abs(float(got[k]) - v) <= METRIC_TOL * (1 + abs(v)), (case, k, float(got[k]), v)
    params = flatten(jax.tree.map(np.asarray, jt.params))
    state = flatten(jax.tree.map(np.asarray, jt.model_state))
    _assert_trees({k[2:]: v for k, v in got.items() if k.startswith("p/")}, params,
                  f"{case} weights")
    _assert_trees({k[2:]: v for k, v in got.items() if k.startswith("s/")}, state,
                  f"{case} statistics")
