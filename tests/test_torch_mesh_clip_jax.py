"""Two gloo ranks of the port against the JAX package's trainer on its
8-device CPU mesh (the JAX SPMD step over a padded, sharded global batch),
for the CLIP trainers whose terms pair rows or read the parameters alone:
PromptSRC (the text L1 at 1/R), IVLP with mixup over the global batch
(JAX's perm and lam handed to the ranks) and KD, PLIP grad (the penalty on
the global CE's gradient).  test-tiny on Synthetic, 16 rows (8 + 8 on the
ranks, 2 on each JAX device: no pad row), 2 steps, at the limits that
tests/test_torch_train.py, tests/test_torch_ivlp.py and
tests/test_torch_plip.py hold one process to: each step's metrics within
1e-4 * (1 + |ref|), the weights at rtol 1e-3 / atol 1e-6 (PLIP: of the
largest entry).
"""

import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))

import torch_mesh_worker as w  # noqa: E402
from test_torch_mesh import _launch  # noqa: E402

JAX_CASES = ["promptsrc16", "ivlp_mixup16", "plip_grad16"]
JAX_KEY0 = 100  # JAX's step s runs on PRNGKey(JAX_KEY0 + s)


def _jax_cfg(case, out_dir):
    from fsvlm_tpu.config import get_cfg_default

    name, settings, _, _ = w.CASES[case]
    cfg = get_cfg_default()
    cfg.merge_from_file(os.path.join(ROOT, "configs", "datasets", "synthetic.yaml"))
    cfg.merge_from_file(os.path.join(ROOT, "configs", "trainers", "tests", "synthetic_tiny.yaml"))
    kv = dict(settings, **{"TRAINER.NAME": name, "OUTPUT_DIR": str(out_dir), "SEED": 1})
    cfg.merge_from_list([x for pair in kv.items() for x in pair])
    return cfg


def _jax_mixup(step, n):
    """JAX's IVLP mixup draws at step ``step`` of a batch of n: (perm, lam)."""
    import jax
    import jax.numpy as jnp

    from fsvlm_tpu.trainers import losses as jax_losses

    _, perm, lam = jax_losses.mixup_batch(jax.random.PRNGKey(JAX_KEY0 + step),
                                          jnp.zeros((n, 1)), 1.0)
    return np.array(perm), np.float32(lam)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The cases on two ranks, JAX's mixup draws handed in, started here and
    run beside the JAX trainers' builds and compiles.  Returns
    ``result(case)``, which waits for the ranks once."""
    root = tmp_path_factory.mktemp("mesh_clip_jax")
    draws = root / "draws.npz"
    np.savez(draws, **{f"ivlp_mixup16/{k}{s}": v for s in range(w.STEPS)
                       for k, v in zip(("perm", "lam"), _jax_mixup(s, 16))})
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

    jt = jax_build_trainer(_jax_cfg(case, tmp_path))
    assert jt.mesh.devices.size == 8
    ref = {}
    for step, (bx, _) in enumerate(w.batches(case, jt.num_classes)):
        jt.params, jt.opt_state, m = jt._train_step(
            jt.params, jt.opt_state, jt.frozen, shard_batch(bx, jt.mesh),
            jax.random.PRNGKey(JAX_KEY0 + step))
        ref.update({f"m{step}/{k}": float(v) for k, v in m.items()})
    got = two_ranks(case)
    for k, v in ref.items():  # per step: the trajectory tests' loss limit
        assert abs(float(got[k]) - v) <= 1e-4 * (1 + abs(v)), (k, float(got[k]), v)
    assert set(got) == set(ref) | {f"p/{k}" for k in jt.params}
    for k, v in jt.params.items():
        v = np.asarray(v)
        atol = 1e-6 * (np.abs(v).max() if case.startswith("plip") else 1.0)
        np.testing.assert_allclose(got[f"p/{k}"], v, rtol=1e-3, atol=atol, err_msg=f"{case} {k}")
