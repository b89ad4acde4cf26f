"""The port's linear-probe tool (fsvlm_tpu_torch/tools/lpclip.py) and its
logistic regression (fsvlm_tpu_torch/tools/logreg.py) against the
repository's tools/lpclip.py and scikit-learn 1.9's ``LogisticRegression``
(imported here only: the port has no sklearn), on the CPU.

- ``LogisticRegression`` against sklearn's lbfgs fit at every C of the
  tool's coarse sweep, on seeded float32 features with class structure
  (Gaussian class means plus noise, 120 x 32, 6 classes, and 2 classes):
  ``coef_`` within rtol 1e-3 of sklearn's relative to its largest entry,
  the (centered) ``intercept_`` likewise, equal predictions on every sample
  whose sklearn top-1/top-2 margin exceeds 1e-4, equal scores, float32
  results, and ``n_iter_`` below ``max_iter`` wherever sklearn's is.  Where
  C is small the fit stops on the float32 loss's rounding (scipy's ftol
  test), and sklearn's own fit moves past 1e-3 when only the order of the
  samples changes: there the bound is twice that spread, measured per C
  from 4 sklearn fits on permuted samples, and the prediction check skips
  the samples on which those fits disagree with sklearn's own.
- At C = 1e6 with max_iter 10, where sklearn stops at max_iter, the port
  warns too, and its predictions are compared.
- ``search_logreg``: the same printed lines and best C as the JAX tool's,
  on the same features.
- ``main`` end to end at test-tiny on configs/datasets/synthetic.yaml (2
  shots, seed 1): the JAX tool's and the port's (``--device cpu``) npz
  files (labels equal, features within 1e-4 of the largest entry) and
  printed lines.
"""

import io
import os
import re
import warnings
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch
from sklearn.exceptions import ConvergenceWarning as SkConvergenceWarning
from sklearn.linear_model import LogisticRegression as SkLogisticRegression
from test_torch_tools import _load_tool
from threadpoolctl import threadpool_limits

from fsvlm_tpu_torch.tools import logreg, lpclip

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COARSE = [10 ** k for k in range(-6, 7, 2)]  # the tool's coarse sweep
RTOL = 1e-3
MARGIN = 1e-4
N_PERMUTED = 4  # sklearn refits on permuted samples, for its own spread
TINY_ARGS = ["--root", "unused", "--dataset-config-file", "configs/datasets/synthetic.yaml",
             "--backbone", "test-tiny", "--num-shots", "2", "--seed", "1"]


def _features(n_classes, n, seed):
    """Seeded float32 features with class structure: Gaussian class means
    (drawn once per class count) plus unit noise."""
    means = np.random.RandomState(100 + n_classes).randn(n_classes, 32)
    rng = np.random.RandomState(seed)
    y = rng.randint(0, n_classes, n)
    return (means[y] + rng.randn(n, 32)).astype(np.float32), y


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


def _centered(intercept):
    return intercept - intercept.mean() if len(intercept) > 1 else intercept


def _margin(clf, X):
    scores = clf.decision_function(X)
    if scores.ndim == 1:
        return np.abs(scores)
    top = np.sort(scores, axis=1)
    return top[:, -1] - top[:, -2]


def _sk_fit(X, y, C, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", SkConvergenceWarning)
        return SkLogisticRegression(C=C, **kw).fit(X, y)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread and one BLAS thread: the fits' many small CPU ops
    stall on a busy machine's spinning thread pools otherwise."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("C", COARSE, ids=[f"C{c:g}" for c in COARSE])
@pytest.mark.parametrize("n_classes", [6, 2], ids=["multinomial", "binary"])
def test_logreg_matches_sklearn(n_classes, C):
    X, y = _features(n_classes, 120, 0)
    X_test, y_test = _features(n_classes, 60, 1)
    sk = _sk_fit(X, y, C)
    port = logreg.LogisticRegression(C=C, device="cpu").fit(X, y)
    print(f"n_iter_ sklearn {sk.n_iter_} port {port.n_iter_}")

    assert port.coef_.dtype == sk.coef_.dtype == np.float32
    assert port.intercept_.dtype == np.float32
    assert port.coef_.shape == sk.coef_.shape and port.intercept_.shape == sk.intercept_.shape
    np.testing.assert_array_equal(port.classes_, sk.classes_)
    assert port.n_iter_.shape == (1,) and port.n_iter_.dtype == np.int32
    if sk.n_iter_[0] < 1000:
        assert port.n_iter_[0] < 1000

    # sklearn's own spread at this C: its fits on permuted samples
    spread, unstable = 0.0, np.zeros(len(y) + len(y_test), bool)
    for seed in range(N_PERMUTED):
        perm = np.random.RandomState(seed).permutation(len(y))
        other = _sk_fit(X[perm], y[perm], C)
        spread = max(spread, _rel(other.coef_, sk.coef_),
                     _rel(_centered(other.intercept_), _centered(sk.intercept_)))
        both = np.concatenate([X, X_test])
        unstable |= other.predict(both) != sk.predict(both)
    bound = max(RTOL, 2 * spread)
    coef_err = _rel(port.coef_, sk.coef_)
    int_err = _rel(_centered(port.intercept_), _centered(sk.intercept_))
    print(f"coef {coef_err:.2e} intercept {int_err:.2e} sklearn's spread {spread:.2e} "
          f"bound {bound:.2e}")
    assert coef_err <= bound and int_err <= bound

    for Xs, ys, unst in ((X, y, unstable[:len(y)]), (X_test, y_test, unstable[len(y):])):
        sure = (_margin(sk, Xs) > MARGIN) & ~unst
        np.testing.assert_array_equal(port.predict(Xs)[sure], sk.predict(Xs)[sure])
        if sure.all():
            assert port.score(Xs, ys) == sk.score(Xs, ys)


def test_logreg_warns_at_max_iter_like_sklearn():
    """C = 1e6 on separable data, max_iter 10: sklearn stops at max_iter
    with a ConvergenceWarning, and so does the port; predictions agree."""
    X, y = _features(6, 120, 0)
    X = X * 4  # the class means 4x further apart: separable
    with warnings.catch_warnings(record=True) as sk_warned:
        warnings.simplefilter("always")
        sk = SkLogisticRegression(C=1e6, max_iter=10).fit(X, y)
    with warnings.catch_warnings(record=True) as port_warned:
        warnings.simplefilter("always")
        port = logreg.LogisticRegression(C=1e6, max_iter=10, device="cpu").fit(X, y)
    assert sk.n_iter_[0] == 10 and port.n_iter_[0] == 10
    assert any(issubclass(w.category, SkConvergenceWarning) for w in sk_warned)
    msgs = [str(w.message) for w in port_warned
            if issubclass(w.category, logreg.ConvergenceWarning)]
    assert msgs and "max_iter=10" in msgs[0]
    assert sk.score(X, y) == 1.0
    sure = _margin(sk, X) > MARGIN
    np.testing.assert_array_equal(port.predict(X)[sure], sk.predict(X)[sure])


def test_logreg_label_values_and_errors():
    """Labels that are not 0..K-1 come back as themselves; one class raises;
    numpy input without a device goes to the card (raises without one)."""
    X, y = _features(6, 120, 0)
    labels = np.array([3, 7, 11, 20, 21, 40])[y]
    sk = _sk_fit(X, labels, 1.0)
    port = logreg.LogisticRegression(device="cpu").fit(X, labels)
    np.testing.assert_array_equal(port.classes_, sk.classes_)
    np.testing.assert_array_equal(port.predict(X), sk.predict(X))
    with pytest.raises(ValueError, match="only one class"):
        logreg.LogisticRegression(device="cpu").fit(X, np.zeros(120, int))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            logreg.LogisticRegression().fit(X, y)


def _search_lines(fn, *args, **kw):
    out = io.StringIO()
    with redirect_stdout(out), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        best = fn(*args, **kw)
    return out.getvalue().splitlines(), best


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX tool's main and the port's (--device cpu) at test-tiny:
    {side: (output dir, printed lines)}."""
    import sys

    jax_tool = _load_tool("lpclip")
    out = {}
    for side in ("jax", "port"):
        d = str(tmp_path_factory.mktemp(side))
        console = io.StringIO()
        argv = TINY_ARGS + ["--output-dir", d]
        saved = sys.argv
        try:
            with redirect_stdout(console), warnings.catch_warnings():
                warnings.simplefilter("ignore")
                if side == "jax":
                    sys.argv = ["lpclip.py"] + argv
                    jax_tool.main()
                else:
                    lpclip.main(argv + ["--device", "cpu"])
        finally:
            sys.argv = saved
        out[side] = (d, console.getvalue().splitlines())
    return out


def _npz(d, split):
    with np.load(os.path.join(d, f"{split}.npz")) as z:
        return z["feature_list"], z["label_list"]


@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_lpclip_npz_matches_jax(runs, split):
    jf, jy = _npz(runs["jax"][0], split)
    pf, py = _npz(runs["port"][0], split)
    np.testing.assert_array_equal(py, jy)
    assert pf.dtype == np.float32 and pf.shape == jf.shape
    assert np.abs(pf - jf).max() <= 1e-4 * np.abs(jf).max()


def test_lpclip_printed_lines_match_jax(runs):
    """Every line from the features' shapes on: the C sweep, the best C and
    the result."""
    def tail(lines):
        return lines[next(i for i, ln in enumerate(lines) if ln.startswith("train: features")):]

    jax_lines, port_lines = tail(runs["jax"][1]), tail(runs["port"][1])
    assert port_lines == jax_lines
    assert any(ln.startswith("Best C:") for ln in port_lines)
    assert port_lines[-2:][0] == "=> result" and port_lines[-1].startswith("* accuracy:")


@pytest.mark.parametrize("features", ["tool_npz", "gaussian"])
def test_search_logreg_prints_jax_lines(runs, features):
    if features == "tool_npz":
        d = runs["jax"][0]
        args = (*_npz(d, "train"), *_npz(d, "val"))
    else:
        args = (*_features(6, 120, 0), *_features(6, 60, 1))
    jax_lines, jax_c = _search_lines(_load_tool("lpclip").search_logreg, *args)
    port_lines, port_c = _search_lines(lpclip.search_logreg, *args, device="cpu")
    print("\n".join(port_lines))
    assert port_lines == jax_lines and port_c == jax_c


def _flags(path):
    with open(path) as f:
        return re.findall(r"add_argument\(\s*\"(--[\w-]+)\"", f.read())


def test_lpclip_takes_the_jax_flags_and_defaults_to_cuda():
    parser = lpclip.build_argparser()
    ours = [a.option_strings[0] for a in parser._actions if a.option_strings][1:]
    assert ours == _flags(os.path.join(ROOT, "tools", "lpclip.py")) + ["--device"]
    args = parser.parse_args(["--root", "r", "--dataset-config-file", "d"])
    assert (args.backbone, args.num_shots, args.seed, args.output_dir, args.device) == (
        "RN50", 16, 1, "./lpclip_out", "cuda")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            lpclip.main(TINY_ARGS)
        X, y = _features(6, 30, 0)
        with pytest.raises(RuntimeError, match="CUDA"):
            lpclip.search_logreg(X, y, X, y)
