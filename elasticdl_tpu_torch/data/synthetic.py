"""Synthetic dataset generators — the port's copy of
``elasticdl_tpu/data/synthetic.py``, cut to the language-model family
(``synthetic_lm``); the other families come with their models' slices.

Used by tests and the chip smoke run when no real dataset is mounted.
Tokens follow a hidden next-token rule so the model demonstrably learns.
"""

from __future__ import annotations

import os

import numpy as np

from elasticdl_tpu_torch.data import codecs
from elasticdl_tpu_torch.data.recordio import RecordIOWriter


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
    "lm": synthetic_lm,
}


def generate(family: str, path: str, n: int, seed: int = 0, **kwargs) -> str:
    if family not in _GENERATORS:
        raise ValueError(f"unknown family {family!r}, pick from {sorted(_GENERATORS)}")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    return _GENERATORS[family](path, n, seed, **kwargs)
