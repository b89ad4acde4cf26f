"""The port's serving export (fsvlm_tpu_torch/tools/export_serving.py)
against the repository's tools/export_serving.py, on the CPU.

- ``build_serving_fn`` at test-tiny (5 classes, batch 4, the same numpy
  weights from seed 0, ``RandomState(0)`` images) against JAX's: fp32 top-1
  equal and logits within 1e-4 relative; int8 (dynamic and static, the
  static scales calibrated on the same ``RandomState(7)`` pixels) at most a
  third of JAX-int8's distance to JAX-fp32 from JAX-int8
  (test_torch_quant.py's RATIO rule: an ulp at an int8 rounding tie flips a
  step, and flips decorrelate over layers);
- the round trip ``export_serving`` -> ``load_serving`` exact against the
  live function (top-1 equal, logits within 1e-6) in fp32 and int8, and
  again with a second set of weights (seed 1), which shows that the
  weights are the program's input and not its constants; the archive holds
  no copy of them;
- the loaded program refuses inputs with other strides than it was
  exported with (a row-major int8 weight), other names, or another device;
- the export traces the kernels' operator where the card would run it:
  with the route's device test patched (there is no card here), the graph
  holds one ``fsvlm.flash_attn_fwd_d64`` node per image-tower layer and no
  softmax or SDPA;
- the command line takes the JAX tool's flags plus ``--device`` and prints
  its line; without a card, the default device raises.
"""

import io
import os
import zipfile
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_lpclip import _flags
from test_torch_quant import RATIO
from test_torch_tools import _load_tool

from fsvlm_tpu_torch.models.clip import ARCHS
from fsvlm_tpu_torch.ops import flash_attention as fa
from fsvlm_tpu_torch.tools import export_serving as tool

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH, N_CLASSES, BATCH = "test-tiny", 5, 4
VARIANTS = {"fp32": {}, "int8": {"int8": True}, "int8_static": {"int8": True, "int8_static": True}}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread: beside the suite's other workers a thread pool per
    op oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _images(seed=0):
    return np.random.RandomState(seed).randint(0, 256, (BATCH, 32, 32, 3), dtype=np.uint8)


@pytest.fixture(scope="module")
def jax_outputs():
    """JAX's serving function at test-tiny per variant: (top-1, logits)."""
    jax_tool = _load_tool("export_serving")
    out = {}
    for name, kw in VARIANTS.items():
        serve, params, _ = jax_tool.build_serving_fn(ARCH, N_CLASSES, **kw)
        top1, logits = jax.jit(serve)(params, jnp.asarray(_images()))
        out[name] = (np.asarray(top1), np.asarray(logits))
    return out


def _live(seed=0, **kw):
    serve, params, res = tool.build_serving_fn(ARCH, N_CLASSES, seed=seed, device="cpu", **kw)
    assert res == ARCHS[ARCH].image_resolution
    with torch.no_grad():
        top1, logits = serve(params, torch.from_numpy(_images()))
    return serve, params, top1, logits


def test_serving_fn_matches_jax_fp32(jax_outputs):
    _, params, top1, logits = _live()
    j_top1, j_logits = jax_outputs["fp32"]
    assert top1.dtype == torch.int32 and logits.dtype == torch.float32
    np.testing.assert_array_equal(top1.numpy(), j_top1)
    assert np.abs(logits.numpy() - j_logits).max() <= 1e-4 * np.abs(j_logits).max()
    assert all(k.startswith("visual.") for k in params)


@pytest.mark.parametrize("variant", ["int8", "int8_static"])
def test_serving_fn_int8_matches_jax(jax_outputs, variant):
    _, params, _, logits = _live(**VARIANTS[variant])
    j_q, j_fp = jax_outputs[variant][1], jax_outputs["fp32"][1]
    gap = np.linalg.norm(j_q - j_fp)
    assert gap > 0
    assert np.linalg.norm(logits.numpy() - j_q) <= RATIO * gap
    q8 = [k for k in params if k.endswith(".q8")]
    assert q8 and all(params[k].dtype == torch.int8 for k in q8)
    assert (variant == "int8_static") == any(k.endswith(".xs") for k in params)


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """{variant: (path, params, nbytes)} exported on the CPU."""
    out = {}
    for name, kw in VARIANTS.items():
        path = str(tmp_path_factory.mktemp("export") / f"{name}.pt2")
        params, nbytes = tool.export_serving(ARCH, N_CLASSES, BATCH, path, device="cpu", **kw)
        out[name] = (path, params, nbytes)
    return out


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_export_round_trip_is_exact(exported, variant):
    path, params, nbytes = exported[variant]
    assert nbytes == os.path.getsize(path) > 0
    with zipfile.ZipFile(path) as z:  # the weights are an input, not in the archive
        assert sum(i.file_size for i in z.infolist() if "/data/" in i.filename) < 4096
    program = tool.load_serving(path, device="cpu")
    serve0, _, top1, logits = _live(**VARIANTS[variant])
    a_top1, a_logits = program(params, torch.from_numpy(_images()))
    np.testing.assert_array_equal(a_top1.numpy(), top1.numpy())
    assert (a_logits - logits).abs().max().item() <= 1e-6
    # a second set of weights through the same artifact: the live function
    # (its text features from seed 0) on those weights
    params1 = _live(seed=1, **VARIANTS[variant])[1]
    with torch.no_grad():
        top1_1, logits_1 = serve0(params1, torch.from_numpy(_images()))
    b_top1, b_logits = program(params1, torch.from_numpy(_images()))
    np.testing.assert_array_equal(b_top1.numpy(), top1_1.numpy())
    assert (b_logits - logits_1).abs().max().item() <= 1e-6
    assert (b_logits - a_logits).abs().max().item() > 1e-3


def test_loaded_program_refuses_other_layouts_names_and_devices(exported):
    path, params, _ = exported["int8"]
    program = tool.load_serving(path, device="cpu")
    images = torch.from_numpy(_images())
    q8 = next(k for k in params if k.endswith(".q8"))
    assert params[q8].transpose(-1, -2).is_contiguous()  # stored column-major
    assert program.expected[q8].stride() == params[q8].stride()
    with pytest.raises(ValueError, match="strides"):
        program(dict(params, **{q8: params[q8].contiguous()}), images)
    with pytest.raises(ValueError, match="missing"):
        program({k: v for k, v in params.items() if k != q8}, images)
    with pytest.raises(ValueError, match="strides|shape"):
        program(params, images[:2])
    with pytest.raises(ValueError, match="exported for cpu"):
        tool.load_serving(path, device="meta")


def test_export_traces_the_kernel_operator(monkeypatch):
    """The route's device test patched to the card's answer: the traced
    graph calls ``fsvlm.flash_attn_fwd_d64`` once per image-tower layer
    (test-tiny: one head of 64), through its fake implementation, and no
    plain attention."""
    serve, params, res = tool.build_serving_fn(ARCH, N_CLASSES, device="cpu")
    monkeypatch.setattr(fa, "_plain", lambda impl, q: False)
    monkeypatch.setattr(fa, "_check_inputs", lambda *a, **k: None)
    with torch.no_grad():
        ep = torch.export.export(serve, (params, torch.zeros((BATCH, res, res, 3), dtype=torch.uint8)))
    ops = tool.graph_ops(ep)
    assert ops["fsvlm.flash_attn_fwd_d64.default"] == ARCHS[ARCH].vision_layers
    assert not [k for k in ops if any(w in k for w in ("softmax", "scaled_dot_product",
                                                        "logsumexp", "blockwise", "fused"))]


def test_command_line_takes_the_jax_flags_and_prints_its_line(tmp_path):
    assert _flags(tool.__file__) == _flags(os.path.join(ROOT, "tools", "export_serving.py")) + [
        "--device"]
    out = str(tmp_path / "s.pt2")
    console = io.StringIO()
    with redirect_stdout(console):
        tool.main(["--arch", ARCH, "--classes", "5", "--batch", "4", "--out", out, "--int8",
                   "--device", "cpu"])
    said = console.getvalue().strip()
    mb = os.path.getsize(out) / 1e6
    assert said == (f"wrote {out} ({mb:.2f} MB, arch={ARCH}, classes=5, batch=4, int8=True)")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tool.main(["--arch", ARCH, "--out", out])
        with pytest.raises(RuntimeError, match="CUDA"):
            tool.load_serving(out)
