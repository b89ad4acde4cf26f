"""The classification evaluator (counterpart of fsvlm_tpu.engine.evaluator,
:36-125), numpy only: the JAX package's ``engine/__init__.py`` imports jax,
and it scores with scikit-learn, which the card's machine lacks.

``Classification`` streams (logits or predictions, labels) and reports top-1
accuracy, error and macro-F1 over the labels present in the ground truth
(scikit-learn's ``f1_score(..., average="macro", labels=unique(y_true))``,
0 where precision and recall are both 0); with TEST.PER_CLASS_RESULT the
per-class accuracies and their mean; with TEST.COMPUTE_CMAT the confusion
matrix normalized over the true labels (``confusion_matrix(...,
normalize="true")``), kept as ``cmat`` since the port has no OUTPUT_DIR.
The printed block is the JAX package's, which tools/parse_test_res.py reads.
"""

from collections import OrderedDict, defaultdict

import numpy as np


class Classification:
    def __init__(self, cfg, lab2cname=None):
        self.cfg = cfg
        self._lab2cname = lab2cname
        self._per_class = cfg.TEST.PER_CLASS_RESULT
        self.cmat = None
        self.reset()

    def reset(self):
        self._correct = 0
        self._total = 0
        self._y_true = []
        self._y_pred = []
        self._per_class_res = defaultdict(list) if self._per_class else None

    def process(self, mo, gt):
        """mo: (B, C) logits or (B,) predicted labels; gt: (B,) labels."""
        mo = np.asarray(mo)
        gt = np.asarray(gt)
        pred = mo.argmax(axis=1) if mo.ndim == 2 else mo
        matches = (pred == gt).astype(np.int64)
        self._correct += int(matches.sum())
        self._total += int(gt.shape[0])
        self._y_true.extend(gt.tolist())
        self._y_pred.extend(pred.tolist())
        if self._per_class_res is not None:
            for label, m in zip(gt.tolist(), matches.tolist()):
                self._per_class_res[label].append(int(m))

    def evaluate(self):
        results = OrderedDict()
        acc = 100.0 * self._correct / max(self._total, 1)
        err = 100.0 - acc
        macro_f1 = 100.0 * macro_f1_score(self._y_true, self._y_pred)
        results["accuracy"] = acc
        results["error_rate"] = err
        results["macro_f1"] = macro_f1

        print(
            "=> result\n"
            f"* total: {self._total:,}\n"
            f"* correct: {self._correct:,}\n"
            f"* accuracy: {acc:.1f}%\n"
            f"* error: {err:.1f}%\n"
            f"* macro_f1: {macro_f1:.1f}%"
        )

        if self._per_class_res is not None:
            print("=> per-class result")
            accs = []
            for label in sorted(self._per_class_res):
                res = self._per_class_res[label]
                class_acc = 100.0 * sum(res) / len(res)
                accs.append(class_acc)
                cname = self._lab2cname.get(label, "?") if self._lab2cname else "?"
                print(
                    f"* class: {label} ({cname})\t"
                    f"total: {len(res):,}\t"
                    f"correct: {sum(res):,}\t"
                    f"acc: {class_acc:.1f}%"
                )
            mean_acc = float(np.mean(accs))
            print(f"* average: {mean_acc:.1f}%")
            results["perclass_accuracy"] = mean_acc

        if self.cfg.TEST.COMPUTE_CMAT:
            self.cmat = confusion_matrix_true(self._y_true, self._y_pred)
            print(f"Confusion matrix computed ({self.cmat.shape[0]} labels), kept as cmat")

        return results

    @property
    def y_true(self):
        return list(self._y_true)

    @property
    def y_pred(self):
        return list(self._y_pred)


def macro_f1_score(y_true, y_pred):
    """Mean F1 over the labels in y_true (0 for a label with no true or
    predicted positive)."""
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    f1 = []
    for label in np.unique(y_true):
        tp = np.sum((y_pred == label) & (y_true == label))
        n_pred, n_true = np.sum(y_pred == label), np.sum(y_true == label)
        precision = tp / n_pred if n_pred else 0.0
        recall = tp / n_true if n_true else 0.0
        f1.append(2 * precision * recall / (precision + recall) if precision + recall else 0.0)
    return float(np.mean(f1)) if f1 else 0.0


def confusion_matrix_true(y_true, y_pred):
    """Counts over the sorted union of labels (rows true, columns
    predicted), each row divided by its sum."""
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    labels = np.unique(np.concatenate([y_true, y_pred]))
    index = {label: i for i, label in enumerate(labels.tolist())}
    cm = np.zeros((len(labels), len(labels)))
    for t, p in zip(y_true.tolist(), y_pred.tolist()):
        cm[index[t], index[p]] += 1
    with np.errstate(all="ignore"):
        cm = cm / cm.sum(axis=1, keepdims=True)
    return np.nan_to_num(cm)
