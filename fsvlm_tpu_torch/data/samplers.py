"""Index samplers (counterpart of fsvlm_tpu.data.samplers, kept line for line:
the same random.Random and np.random.RandomState calls in the same order,
so that one seed gives the same index order in both packages; parity:
dassl/data/samplers.py:9-249).

A sampler yields dataset indices for one epoch.  The fork's
WeightedClassSampler (:181-212) — inverse-class-frequency sampling with
replacement for class-balanced batches under imbalance — is first-class here.
"""

import random
from collections import defaultdict

import numpy as np


class RandomSampler:
    def __init__(self, data_source, seed=None):
        self.n = len(data_source)
        self.rng = random.Random(seed)

    def __iter__(self):
        idxs = list(range(self.n))
        self.rng.shuffle(idxs)
        return iter(idxs)

    def __len__(self):
        return self.n


class SequentialSampler:
    def __init__(self, data_source, seed=None):
        self.n = len(data_source)

    def __iter__(self):
        return iter(range(self.n))

    def __len__(self):
        return self.n


class RandomClassSampler:
    """Sample N classes x K instances per batch (samplers.py:118-178)."""

    def __init__(self, data_source, batch_size, n_ins, seed=None):
        # the reference only requires batch_size >= n_ins and floors the
        # class count (samplers.py:131-141) — non-divisible batches sample
        # batch_size//n_ins classes
        if batch_size < n_ins:
            raise ValueError(
                f"batch_size={batch_size} must be no less than n_ins={n_ins}"
            )
        self.index_dict = defaultdict(list)
        for i, item in enumerate(data_source):
            self.index_dict[item.label].append(i)
        self.labels = list(self.index_dict.keys())
        self.n_cls = batch_size // n_ins
        if len(self.labels) < self.n_cls:
            # loud at construction (samplers.py:146) — otherwise __iter__
            # silently yields an empty epoch
            raise ValueError(
                f"RandomClassSampler needs >= {self.n_cls} classes, "
                f"dataset has {len(self.labels)}"
            )
        self.n_ins = n_ins
        self.batch_size = batch_size
        self.rng = random.Random(seed)
        self.length = len(data_source)

    def __iter__(self):
        batch_idxs_dict = defaultdict(list)
        rng = self.rng
        for label in self.labels:
            idxs = list(self.index_dict[label])
            if len(idxs) < self.n_ins:
                idxs = rng.choices(idxs, k=self.n_ins)
            rng.shuffle(idxs)
            batch, chunks = [], []
            for idx in idxs:
                batch.append(idx)
                if len(batch) == self.n_ins:
                    chunks.append(batch)
                    batch = []
            batch_idxs_dict[label] = chunks

        avai_labels = [l for l in self.labels if batch_idxs_dict[l]]
        final = []
        while len(avai_labels) >= self.n_cls:
            selected = rng.sample(avai_labels, self.n_cls)
            for label in selected:
                final.extend(batch_idxs_dict[label].pop(0))
                if not batch_idxs_dict[label]:
                    avai_labels.remove(label)
        return iter(final)

    def __len__(self):
        return self.length


class RandomDomainSampler:
    """Sample N domains x K images per minibatch (samplers.py:9-62): keep
    drawing domain subsets without replacement within an epoch until some
    selected domain can no longer fill its quota."""

    def __init__(self, data_source, batch_size, n_domain, seed=None):
        self.domain_dict = defaultdict(list)
        for i, item in enumerate(data_source):
            self.domain_dict[item.domain].append(i)
        self.domains = list(self.domain_dict.keys())
        if n_domain is None or n_domain <= 0:
            n_domain = len(self.domains)
        if batch_size % n_domain != 0:
            raise ValueError("batch_size must be divisible by n_domain")
        self.n_img_per_domain = batch_size // n_domain
        self.n_domain = n_domain
        self.rng = random.Random(seed)
        self.length = len(list(iter(self)))

    def __iter__(self):
        rng = self.rng
        pools = {d: list(v) for d, v in self.domain_dict.items()}
        final = []
        stop = False
        while not stop:
            for domain in rng.sample(self.domains, self.n_domain):
                picked = rng.sample(pools[domain], self.n_img_per_domain)
                final.extend(picked)
                for idx in picked:
                    pools[domain].remove(idx)
                if len(pools[domain]) < self.n_img_per_domain:
                    stop = True
        return iter(final)

    def __len__(self):
        return self.length


class SeqDomainSampler:
    """Fixed (sorted) domain order, K random images per domain per batch
    (samplers.py:65-116)."""

    def __init__(self, data_source, batch_size, seed=None):
        self.domain_dict = defaultdict(list)
        for i, item in enumerate(data_source):
            self.domain_dict[item.domain].append(i)
        self.domains = sorted(self.domain_dict.keys())
        if batch_size % len(self.domains) != 0:
            raise ValueError("batch_size must be divisible by the domain count")
        self.n_img_per_domain = batch_size // len(self.domains)
        self.rng = random.Random(seed)
        self.length = len(list(iter(self)))

    def __len__(self):
        return self.length

    def __iter__(self):
        rng = self.rng
        pools = {d: list(v) for d, v in self.domain_dict.items()}
        final = []
        stop = False
        while not stop:
            for domain in self.domains:
                picked = rng.sample(pools[domain], self.n_img_per_domain)
                final.extend(picked)
                for idx in picked:
                    pools[domain].remove(idx)
                if len(pools[domain]) < self.n_img_per_domain:
                    stop = True
        return iter(final)


class WeightedClassSampler:
    """Inverse-class-frequency sampling with replacement — the fork's
    class-balanced sampler (samplers.py:181-212).  Each index i is drawn with
    probability proportional to 1/count(label_i)."""

    def __init__(self, data_source, seed=None, num_samples=None):
        labels = np.asarray([item.label for item in data_source])
        counts = np.bincount(labels)
        weights = 1.0 / counts[labels].astype(np.float64)
        self.probs = weights / weights.sum()
        self.num_samples = num_samples or len(data_source)
        self.rng = np.random.RandomState(seed)

    def __iter__(self):
        drawn = self.rng.choice(len(self.probs), size=self.num_samples, replace=True, p=self.probs)
        return iter(drawn.tolist())

    def __len__(self):
        return self.num_samples


def build_sampler(
    sampler_type, data_source, batch_size=32, n_domain=0, n_ins=16, seed=None
):
    """Factory (samplers.py:215-249)."""
    if sampler_type == "RandomSampler":
        return RandomSampler(data_source, seed)
    if sampler_type == "SequentialSampler":
        return SequentialSampler(data_source, seed)
    if sampler_type == "RandomClassSampler":
        return RandomClassSampler(data_source, batch_size, n_ins, seed)
    if sampler_type == "WeightedClassSampler":
        return WeightedClassSampler(data_source, seed)
    if sampler_type == "RandomDomainSampler":
        return RandomDomainSampler(data_source, batch_size, n_domain, seed)
    if sampler_type == "SeqDomainSampler":
        return SeqDomainSampler(data_source, batch_size, seed)
    raise ValueError(f"Unknown sampler type: {sampler_type}")
