"""Record codecs of the port — the language-modeling pair from
``elasticdl_tpu/data/codecs.py`` (numpy only).  The other models' codecs
come with their slices of the port.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from elasticdl_tpu_torch.data.packed import concat_records


def encode_lm_example(tokens: np.ndarray) -> bytes:
    """One training sequence of S+1 int32 token ids (the +1 supplies the
    next-token labels; the feed splits tokens[:-1] / tokens[1:], so the
    label shift never crosses a sequence-parallel shard boundary)."""
    return np.ascontiguousarray(tokens, np.int32).tobytes()


def lm_feed(records: Sequence[bytes]) -> dict:
    buf = concat_records(records).view(np.int32)
    seq_plus_1 = len(records[0]) // 4
    seqs = buf.reshape(len(records), seq_plus_1)
    return {
        "tokens": np.ascontiguousarray(seqs[:, :-1]),
        "labels": np.ascontiguousarray(seqs[:, 1:]),
    }
