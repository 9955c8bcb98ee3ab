"""Feature preprocessing layers — the port of
``elasticdl_tpu/preprocessing``: Hashing, IndexLookup, Normalizer,
Discretization, RoundIdentity, ToNumber and ConcatenateWithOffset, the
reference's replacements for ``tf.feature_column`` in its tabular models.

Each layer is stateful at fit time and pure at call time.  ``adapt()``
(vocab building, moment accumulation, quantile boundaries) runs on the
host over numpy batches, in the feed stage.  ``__call__`` keeps numpy
input on the host, bit for bit the reference's numpy results, and runs on
a torch tensor where it lies (the card or the CPU) with the same integer
results; strings are host-only.
"""

from elasticdl_tpu_torch.preprocessing.layers import (
    ConcatenateWithOffset,
    Discretization,
    Hashing,
    IndexLookup,
    Normalizer,
    RoundIdentity,
    ToNumber,
)

__all__ = [
    "Hashing",
    "IndexLookup",
    "Normalizer",
    "Discretization",
    "RoundIdentity",
    "ToNumber",
    "ConcatenateWithOffset",
]
