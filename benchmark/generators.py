"""The traffic generators: each turns a traffic file's parameters and the
run's seed into the rows a cell trains on, the same rows for the same
seed. Rows are numpy arrays on the host; ``records.py`` writes them in
the program's file formats, and the reference reads the arrays.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np


def rng_for(seed: int, stream: str) -> np.random.Generator:
    """An independent stream of the run's seed (any non-negative integer,
    more than 32 bits included), one a purpose."""
    return np.random.default_rng([int(seed), *stream.encode()])


def lm_tokens(rng: np.random.Generator, n: int, seq_len: int, vocab: int,
              noise: float) -> np.ndarray:
    """``[n, seq_len + 1]`` int32 token rows from a noisy affine
    next-token rule (``t -> 31 t + 7 mod vocab``, a uniform token with
    probability ``noise``), the rule ``data/synthetic.synthetic_lm`` plants
    so that a model can learn it. Row starts are uniform."""
    toks = np.empty((n, seq_len + 1), np.int64)
    toks[:, 0] = rng.integers(0, vocab, size=n)
    draws = rng.integers(0, vocab, size=(seq_len, n))
    flips = rng.random((seq_len, n)) < noise
    for t in range(1, seq_len + 1):
        toks[:, t] = np.where(flips[t - 1], draws[t - 1], (toks[:, t - 1] * 31 + 7) % vocab)
    return toks.astype(np.int32)


def _ranks(rng: np.random.Generator, n: int, cardinality: int, law: str,
           exponent: float) -> np.ndarray:
    """Ranks in ``[1, cardinality]``: uniform, or Zipf-like by the inverse
    CDF of the continuous power law ``x^-exponent`` on ``[1, cardinality +
    1)``, floored (rank k has probability close to ``k^-exponent``
    normalised; exact for large k)."""
    u = rng.random(n)
    if law == "uniform":
        return 1 + np.minimum((u * cardinality).astype(np.int64), cardinality - 1)
    if law != "zipf":
        raise ValueError(f"unknown id law {law!r}")
    a = 1.0 - exponent
    top = (cardinality + 1.0) ** a
    x = (1.0 + u * (top - 1.0)) ** (1.0 / a)
    return np.clip(np.floor(x).astype(np.int64), 1, cardinality)


def criteo_rows(seed: int, stream: str, n: int, p: dict,
                pool: Optional[ThreadPoolExecutor] = None) -> dict:
    """Criteo-shaped rows: ``labels`` uint8 [n], ``dense`` int64 [n, 13]
    (-1 marks a missing value), ``cats`` uint32 [n, 26] raw ids.

    Each categorical field ``f`` draws a rank from ``p["id_law"]`` over
    ``p["cardinalities"][f]`` values and maps it to a raw 32-bit id by an
    odd multiplier and a per-field offset (distinct ranks stay distinct
    within a field; the program hashes raw ids into its buckets). Each
    integer field is a heavy-tailed count, ``floor(exp(N(mu, sigma)))``,
    missing with probability ``p["dense_missing"]``. The label is a
    Bernoulli draw whose log-odds rise with field 0's rank class and the
    first integer, centred so that about ``p["positive_rate"]`` of the
    labels are 1. Each field draws from a stream of its own, so ``pool``'s
    threads (numpy drops the interpreter lock) give the same rows."""
    cards = p["cardinalities"]
    cats = np.empty((n, len(cards)), np.uint32)

    def field(f: int) -> np.ndarray:
        r = _ranks(rng_for(seed, f"{stream}/cat{f}"), n, int(cards[f]), p["id_law"],
                   float(p.get("zipf_exponent", 1.1)))
        cats[:, f] = ((r * 2654435761 + f * 0x3C6EF372) & 0xFFFFFFFF).astype(np.uint32)
        return r if f == 0 else None

    fields = range(len(cards))
    ranks0 = list(pool.map(field, fields) if pool else map(field, fields))[0]
    rng = rng_for(seed, stream)
    dense = np.floor(np.exp(rng.normal(p["dense_log_mu"], p["dense_log_sigma"],
                                       (n, p["num_dense"])))).astype(np.int64) - 1
    dense = np.maximum(dense, 0)
    dense[rng.random(dense.shape) < p["dense_missing"]] = -1
    rate = float(p["positive_rate"])
    score = np.log(rate / (1 - rate)) + 0.6 * ((ranks0 % 7) - 3) / 3.0 + 0.25 * (
        np.log1p(np.maximum(dense[:, 0], 0)) - p["dense_log_mu"])
    labels = (rng.random(n) < 1.0 / (1.0 + np.exp(-score))).astype(np.uint8)
    return {"labels": labels, "dense": dense, "cats": cats}
