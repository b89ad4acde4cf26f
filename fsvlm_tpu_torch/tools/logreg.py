"""L2-regularized logistic regression fitted by L-BFGS-B: scikit-learn's
``LogisticRegression`` (solver "lbfgs", its default), without scikit-learn.

The linear-probe tool (``tools/lpclip.py``) fits sklearn's estimator; the
port's machines have no sklearn but have scipy, and sklearn's lbfgs solver
is itself ``scipy.optimize.minimize(method="L-BFGS-B")`` over its own loss
and gradient (sklearn 1.9, ``linear_model/_logistic.py:580-595``).  So this
module keeps sklearn's optimizer call and writes its objective in torch, on the
features' device:

* more than two classes: ``HalfMultinomialLoss``, the mean multinomial
  cross-entropy plus ``0.5 / (C * n) * ||coef||^2`` (the intercept is not
  penalized), over parameters (n_classes, n_features + 1) raveled in
  Fortran order, classes contiguous (``_logistic.py:535-539``);
* two classes: ``HalfBinomialLoss`` on one row, the positive class being
  ``classes_[1]`` (``_logistic.py:460-470``, :1576-1578);
* ``w0 = 0``; options maxiter, maxls 50, gtol = tol, ftol = 64 eps.

Precision follows sklearn's float32 path (``_linear_loss.py:186-380``,
``_loss/_loss.pyx.tp``).  w0 has X's dtype, so scipy hands the objective
its float64 iterate cast to X's dtype (and takes two iterates equal in that
dtype for one point).  In X's dtype: the raw predictions X @ W.T + b, the
loss log(sum) + max - raw[y] stored from double, the probabilities p / sum,
the mean loss, the penalty and the gradient, grad_pointwise.T @ X + l2 W;
per row, exp(raw - max) is evaluated in double and stored in X's dtype, and
its sum accumulated in double and stored in X's dtype.  A fit of float32
features keeps float32 ``coef_`` and ``intercept_``.
"""

import warnings

import numpy as np
import torch
from scipy import optimize

from .. import resolve_device


class ConvergenceWarning(UserWarning):
    """sklearn's ``ConvergenceWarning``: L-BFGS-B stopped without meeting
    its tolerance (at ``max_iter`` or on a failed line search)."""


def _exp_minus_max(raw, max_value):
    """exp(raw - max) evaluated in double and stored in raw's dtype, as
    sklearn's ``sum_exp_minus_max`` writes it into a buffer of the input's
    type."""
    return torch.exp(raw.double() - max_value.double()).to(raw.dtype)


def _multinomial_loss_grad(w, X, y, n_classes, l2):
    """sklearn's ``LinearModelLoss(HalfMultinomialLoss).loss_gradient`` at
    the raveled parameters ``w`` (X's dtype): (loss as a float, gradient in
    X's dtype)."""
    n, n_features = X.shape
    coef = torch.from_numpy(w).to(X.device).reshape(n_features + 1, n_classes).T
    weights, intercept = coef[:, :-1], coef[:, -1]
    raw = X @ weights.T + intercept
    max_value = raw.max(dim=1, keepdim=True).values
    p = _exp_minus_max(raw, max_value)
    sum_exps = p.double().sum(dim=1, keepdim=True).to(X.dtype)
    loss_i = (torch.log(sum_exps.double()) + max_value.double()).to(X.dtype)
    loss_i = loss_i[:, 0] - raw.gather(1, y[:, None])[:, 0]
    grad_pointwise = p / sum_exps
    grad_pointwise[torch.arange(n, device=X.device), y] -= 1
    loss = loss_i.sum() / n
    grad_pointwise /= n
    grad = torch.empty((n_classes, n_features + 1), dtype=X.dtype, device=X.device)
    grad[:, :-1] = grad_pointwise.T @ X + l2 * weights
    grad[:, -1] = grad_pointwise.sum(dim=0)
    flat = weights.reshape(-1)
    penalty = 0.5 * l2 * (flat @ flat)
    return float(loss) + float(penalty), grad.T.reshape(-1).cpu().numpy()


def _binomial_loss_grad(w, X, y, l2):
    """sklearn's ``LinearModelLoss(HalfBinomialLoss).loss_gradient``: the
    pointwise loss and gradient in double (``closs_grad_half_binomial``'s
    branches at -37, -2 and 18), stored in X's dtype."""
    n = X.shape[0]
    coef = torch.from_numpy(w).to(X.device)
    weights, intercept = coef[:-1], coef[-1]
    raw = (X @ weights + intercept).double()
    yd = y.double()
    e_pos, e_neg = torch.exp(raw), torch.exp(-raw)
    loss_i = torch.where(
        raw <= -37, e_pos - yd * raw,
        torch.where(raw <= -2, torch.log1p(e_pos) - yd * raw,
                    torch.where(raw <= 18, torch.log1p(e_neg) + (1 - yd) * raw,
                                e_neg + (1 - yd) * raw)))
    grad_i = torch.where(
        raw <= -37, e_pos - yd,
        torch.where(raw <= -2, ((1 - yd) * e_pos - yd) / (1 + e_pos),
                    ((1 - yd) - yd * e_neg) / (1 + e_neg)))
    loss_i, grad_pointwise = loss_i.to(X.dtype), grad_i.to(X.dtype)
    loss = loss_i.sum() / n
    grad_pointwise /= n
    grad = torch.empty(w.shape, dtype=X.dtype, device=X.device)
    grad[:-1] = X.T @ grad_pointwise + l2 * weights
    grad[-1] = grad_pointwise.sum()
    penalty = 0.5 * l2 * (weights @ weights)
    return float(loss) + float(penalty), grad.cpu().numpy()


class LogisticRegression:
    """sklearn's ``LogisticRegression(C, max_iter, tol)`` with its lbfgs
    solver (module note).  ``fit(X, y)``, ``predict(X)``, ``score(X, y)``,
    ``coef_`` (n_classes, n_features), or (1, n_features) for two classes,
    ``intercept_``, ``classes_`` and ``n_iter_`` ((1,) int32) as sklearn
    names them, as numpy arrays.  ``device``: where the loss and gradient
    run; None takes a tensor's own device, and the card for numpy input."""

    def __init__(self, C=1.0, max_iter=1000, tol=1e-4, device=None):
        self.C, self.max_iter, self.tol, self.device = C, max_iter, tol, device

    def _features(self, X):
        if isinstance(X, torch.Tensor):
            dev = X.device if self.device is None else resolve_device(self.device)
        else:
            dev = resolve_device(self.device)
        X = torch.as_tensor(X)
        if X.dtype not in (torch.float32, torch.float64):
            X = X.double()
        return X.to(dev).contiguous()

    def fit(self, X, y):
        X = self._features(X)
        y = y.cpu().numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
        self.classes_ = np.unique(y)
        n_classes = len(self.classes_)
        if n_classes < 2:
            raise ValueError("This solver needs samples of at least 2 classes in the data, "
                             f"but the data contains only one class: {self.classes_[0]!r}")
        n, n_features = X.shape
        if len(y) != n:
            raise ValueError(f"X has {n} samples, y {len(y)}")
        l2 = 1.0 / (self.C * n)
        codes = np.searchsorted(self.classes_, y)
        dtype = np.float32 if X.dtype == torch.float32 else np.float64
        if n_classes == 2:
            target = torch.from_numpy((codes == 1).astype(np.int64)).to(X.device)
            w0 = np.zeros(n_features + 1, dtype)

            def fun(w):
                return _binomial_loss_grad(w, X, target, l2)
        else:
            target = torch.from_numpy(codes.astype(np.int64)).to(X.device)
            w0 = np.zeros(n_classes * (n_features + 1), dtype)

            def fun(w):
                return _multinomial_loss_grad(w, X, target, n_classes, l2)

        res = optimize.minimize(
            fun, w0, method="L-BFGS-B", jac=True,
            options={"maxiter": self.max_iter, "maxls": 50, "gtol": self.tol,
                     "ftol": 64 * np.finfo(float).eps})
        n_iter = min(res.nit, self.max_iter)
        if res.status != 0:
            msg = (f"lbfgs failed to converge after {n_iter} iteration(s) "
                   f"(status={res.status}):\n{res.message}\n")
            if n_iter == self.max_iter:
                msg += ("\nIncrease the number of iterations to improve the convergence "
                        f"(max_iter={self.max_iter}).")
            warnings.warn(msg, ConvergenceWarning, stacklevel=2)
        self.n_iter_ = np.array([n_iter], dtype=np.int32)
        if n_classes == 2:
            self.coef_ = res.x[:-1][None, :].astype(dtype)
            self.intercept_ = res.x[-1:].astype(dtype)
        else:
            coef = res.x.reshape((n_classes, -1), order="F").astype(dtype)
            self.coef_, self.intercept_ = coef[:, :-1], coef[:, -1]
        return self

    def decision_function(self, X):
        """X @ coef_.T + intercept_ in X's dtype, on the fit's device rule:
        (n,) for two classes, else (n, n_classes), as a tensor."""
        X = self._features(X)
        coef = torch.from_numpy(self.coef_).to(X.device, X.dtype)
        scores = X @ coef.T + torch.from_numpy(self.intercept_).to(X.device, X.dtype)
        return scores[:, 0] if scores.shape[1] == 1 else scores

    def predict(self, X):
        scores = self.decision_function(X)
        idx = (scores > 0).long() if scores.dim() == 1 else scores.argmax(dim=1)
        return self.classes_[idx.cpu().numpy()]

    def score(self, X, y):
        """Mean accuracy of ``predict(X)`` against ``y``."""
        y = y.cpu().numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
        return float(np.average(self.predict(X) == y))
