"""Seeds of the benchmark's random streams, each derived from the run's
``--seed`` (any non-negative integer) and a purpose."""

from __future__ import annotations

import numpy as np


def derive(seed: int, purpose: str) -> int:
    """A 63-bit seed for ``torch.Generator.manual_seed``."""
    state = np.random.SeedSequence([int(seed), *purpose.encode()]).generate_state(2, np.uint32)
    return int(state[0]) | (int(state[1] & 0x7FFFFFFF) << 32)
