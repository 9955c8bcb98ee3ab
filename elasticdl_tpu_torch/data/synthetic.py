"""Synthetic dataset generators — the port's copy of
``elasticdl_tpu/data/synthetic.py``: the MNIST, CIFAR-10, Criteo, census
and language-model families.  Each writes the same bytes as the
reference's generator for the same arguments.

Used by tests and the chip smoke run when no real dataset is mounted.
Labels and tokens follow a hidden rule so the models demonstrably learn.
"""

from __future__ import annotations

import os

import numpy as np

from elasticdl_tpu_torch.data import codecs
from elasticdl_tpu_torch.data.recordio import RecordIOWriter


def synthetic_mnist(path: str, n: int, seed: int = 0) -> str:
    rng = np.random.default_rng(seed)
    with RecordIOWriter(path) as w:
        for _ in range(n):
            label = int(rng.integers(0, 10))
            img = rng.integers(0, 256, (28, 28, 1), dtype=np.uint8)
            # A label-dependent bright block, so the task is learnable.
            r, c = divmod(label, 4)
            img[4 + r * 6 : 8 + r * 6, 4 + c * 6 : 8 + c * 6] = 255
            w.write(codecs.encode_image_example(img, label))
    return path


def synthetic_cifar10(path: str, n: int, seed: int = 0) -> str:
    rng = np.random.default_rng(seed)
    with RecordIOWriter(path) as w:
        for _ in range(n):
            label = int(rng.integers(0, 10))
            img = rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)
            img[:, :, label % 3] = np.minimum(255, img[:, :, label % 3] + 25 * label)
            w.write(codecs.encode_image_example(img, label))
    return path


def synthetic_criteo(
    path: str, n: int, seed: int = 0, container: str = "text"
) -> str:
    """Criteo-Kaggle-shaped TSV with a planted CTR rule.

    ``container="text"`` writes newline-delimited TSV (the Kaggle dump's own
    shape); ``"recordio"`` wraps each line in the RecordIO framing the
    reference stores training data in (the native bulk-read path).
    """
    rng = np.random.default_rng(seed)
    sink = RecordIOWriter(path) if container == "recordio" else open(path, "wb")
    with sink as out:
        for _ in range(n):
            dense = rng.integers(0, 1000, 13)
            cats = rng.integers(0, 1 << 20, 26)
            score = 0.002 * dense[0] - 0.001 * dense[1] + ((cats[0] % 7) - 3) * 0.3
            label = int(rng.random() < 1 / (1 + np.exp(-score)))
            rec = codecs.encode_criteo_example(label, dense.tolist(), cats.tolist())
            if container == "recordio":
                out.write(rec)
            else:
                out.write(rec + b"\n")
    return path


_CENSUS_VOCAB = [
    ["private", "gov", "self_emp", "none"],
    ["hs", "college", "bachelors", "masters", "phd"],
    ["married", "single", "divorced"],
    ["tech", "sales", "admin", "exec", "service"],
    ["husband", "wife", "own_child", "unmarried"],
    ["white", "black", "asian", "other"],
    ["male", "female"],
    ["us", "mexico", "other"],
    ["a", "b", "c"],
]


def synthetic_census(path: str, n: int, seed: int = 0) -> str:
    """Census-income-shaped CSV (``label,5 numerics,9 categoricals``, one
    record a line) with a planted income rule."""
    rng = np.random.default_rng(seed)
    with open(path, "wb") as f:
        for _ in range(n):
            dense = [
                float(rng.integers(17, 80)),  # age
                float(rng.integers(1, 16)),  # education_num
                float(rng.choice([0, 0, 0, 5000, 15000])),  # capital_gain
                float(rng.choice([0, 0, 0, 1500])),  # capital_loss
                float(rng.integers(10, 80)),  # hours_per_week
            ]
            cats = [v[rng.integers(0, len(v))] for v in _CENSUS_VOCAB]
            score = (
                0.04 * (dense[0] - 40)
                + 0.3 * (dense[1] - 9)
                + 0.0002 * dense[2]
                + (1.0 if cats[2] == "married" else -0.5)
            )
            label = int(rng.random() < 1 / (1 + np.exp(-score)))
            f.write(codecs.encode_census_example(label, dense, cats))
            f.write(b"\n")
    return path


def synthetic_lm(
    path: str, n: int, seed: int = 0, seq_len: int = 256, vocab: int = 8192
) -> str:
    """Token sequences from a noisy affine next-token rule, so a causal LM
    demonstrably learns (loss falls well below uniform log-vocab)."""
    rng = np.random.default_rng(seed)
    # Vectorized across records: one RNG draw per position for all n
    # sequences (a per-token Python loop costs minutes at dataset scale).
    toks = np.empty((n, seq_len + 1), np.int32)
    toks[:, 0] = rng.integers(0, vocab, size=n)
    for t in range(1, seq_len + 1):
        noise = rng.random(n) < 0.1  # 10% noise keeps entropy positive
        toks[:, t] = np.where(
            noise,
            rng.integers(0, vocab, size=n),
            (toks[:, t - 1] * 31 + 7) % vocab,
        )
    with RecordIOWriter(path) as w:
        for i in range(n):
            w.write(codecs.encode_lm_example(toks[i]))
    return path


_GENERATORS = {
    "mnist": synthetic_mnist,
    "cifar10": synthetic_cifar10,
    "criteo": synthetic_criteo,
    "census": synthetic_census,
    "lm": synthetic_lm,
}


def generate(family: str, path: str, n: int, seed: int = 0, **kwargs) -> str:
    if family not in _GENERATORS:
        raise ValueError(f"unknown family {family!r}, pick from {sorted(_GENERATORS)}")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    return _GENERATORS[family](path, n, seed, **kwargs)
