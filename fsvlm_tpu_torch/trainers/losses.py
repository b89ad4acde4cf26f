"""Loss functions of the prompt-learning trainers (counterpart of
fsvlm_tpu.trainers.losses, all 11 functions).

Parity targets (reference, PromptSRC/trainers/coop.py, simclr_utils.py and
independentVL.py):
- MultiClassFocalLoss (coop.py:131-163): alpha[target] * (1-pt)^gamma * CE,
  alpha the inverse-frequency weights of DATASET.PER_CLASS_SHOTS
  (coop.py:326-346);
- NT-Xent over L2-normalized rows, temperature 0.07 (coop.py:66-128,
  simclr_utils.py:62-86);
- mixup (independentVL.py:12-29) and KD (independentVL.py:32-44).  The
  mixup draws are handed in: the trainer draws them on the device, and tests
  inject the JAX package's threefry draws.

Every batch-reduced loss takes an optional ``valid`` (B,) bool mask: padded
rows of a short final batch repeat the last item and must not weigh in.
Losses are fp32 whatever the input dtype.
"""

import numpy as np
import torch
import torch.nn.functional as F


def masked_mean(per_example, valid=None):
    """Mean of (B,) per-example values over valid rows (plain mean if no
    mask); masked entries are selected away, so they may be inf or NaN."""
    if valid is None:
        return per_example.mean()
    safe = torch.where(valid, per_example, torch.zeros_like(per_example))
    return safe.sum() / valid.to(per_example.dtype).sum().clamp_min(1.0)


def masked_acc(logits, labels, valid=None):
    """Batch top-1 accuracy (%) over valid rows."""
    correct = (logits.argmax(-1) == labels).float()
    return masked_mean(correct, valid) * 100.0


def _ce_per_example(logits, labels):
    return F.cross_entropy(logits.float(), labels, reduction="none")


def cross_entropy(logits, labels, valid=None):
    return masked_mean(_ce_per_example(logits, labels), valid)


def focal_loss(logits, labels, alpha=None, gamma=2.0, valid=None):
    """Multi-class focal loss; ``alpha``: optional (C,) per-class weights."""
    ce = _ce_per_example(logits, labels)
    pt = torch.exp(-ce)
    focal = (1.0 - pt) ** gamma * ce
    if alpha is not None:
        focal = alpha[labels] * focal
    return masked_mean(focal, valid)


def focal_alpha_from_shots(per_class_shots, device=None):
    """Inverse-frequency alpha: total / (n_cls * count), 0 for empty classes
    (coop.py:337-345).  A (C,) float32 tensor on ``device`` (default: CPU)."""
    counts = np.asarray(per_class_shots, np.float32)
    alpha = np.where(counts > 0, counts.sum() / (len(counts) * np.maximum(counts, 1)), 0.0)
    return torch.as_tensor(alpha.astype(np.float32), device=device)


def nt_xent(z1, z2, temperature=0.07, valid=None):
    """SimCLR NT-Xent over two aligned views z1, z2 (N, D), rows
    L2-normalized here.  Positives are (i, i+N); self-similarity is excluded.
    With ``valid``, padded rows are excluded as anchors and as negatives."""
    z1 = z1 / torch.linalg.vector_norm(z1, dim=1, keepdim=True)
    z2 = z2 / torch.linalg.vector_norm(z2, dim=1, keepdim=True)
    z = torch.cat([z1, z2], dim=0).float()
    n2 = z.shape[0]
    n = n2 // 2
    sim = z @ z.T / temperature
    eye = torch.eye(n2, dtype=torch.bool, device=z.device)
    sim = sim.masked_fill(eye, float("-inf"))
    v2 = None
    if valid is not None:
        v2 = torch.cat([valid, valid]).bool()
        sim = sim.masked_fill(~v2[None, :], float("-inf"))
    ar = torch.arange(n, device=z.device)
    pos_idx = torch.cat([ar + n, ar])
    per_row = torch.logsumexp(sim, dim=1) - sim[torch.arange(n2, device=z.device), pos_idx]
    if v2 is not None:
        per_row = torch.where(v2, per_row, torch.zeros_like(per_row))
        return per_row.sum() / v2.float().sum().clamp_min(1.0)
    return per_row.mean()


def mixup_batch(images, perm, lam):
    """(lam * images + (1 - lam) * images[perm], perm, lam): mixup_data's
    semantics (independentVL.py:12-21) on draws handed in, ``perm`` a (B,)
    permutation and ``lam`` a scalar (a 0-dim tensor keeps it on the
    device)."""
    mixed = lam * images + (1.0 - lam) * images[perm]
    return mixed, perm, lam


def mixup_criterion(loss_fn, logits, labels_a, labels_b, lam):
    return lam * loss_fn(logits, labels_a) + (1.0 - lam) * loss_fn(logits, labels_b)


def kl_logits(student_logits, teacher_logits, T=1.0, valid=None):
    """KL(softmax(teacher/T) || softmax(student/T)) per row, over valid rows,
    times T^2; the teacher's probabilities are clipped at 1e-12 inside the
    log."""
    s = F.log_softmax(student_logits.float() / T, dim=1)
    t = F.softmax(teacher_logits.float() / T, dim=1)
    per_row = (t * (torch.log(t.clamp_min(1e-12)) - s)).sum(dim=1)
    return masked_mean(per_row, valid) * (T * T)


def kd_loss(student_logits, teacher_logits, T=4.0, valid=None):
    """Knowledge distillation (independentVL.py:32-44): ``kl_logits`` at the
    KD temperature."""
    return kl_logits(student_logits, teacher_logits, T=T, valid=valid)


def l1_loss(a, b, valid=None):
    """Elementwise-mean L1; with ``valid``, rows (axis 0) are masked.  Where
    a equals b the gradient is +1, JAX's rule for abs (torch's is 0): at
    LoRA's init (B = 0) the student's image features equal the teacher's
    exactly, and the first step's gradients must be JAX's."""
    x = a.float() - b.float()
    d = torch.where(x >= 0, x, -x)
    if valid is None:
        return d.mean()
    return masked_mean(d.reshape(d.shape[0], -1).mean(dim=1), valid)
