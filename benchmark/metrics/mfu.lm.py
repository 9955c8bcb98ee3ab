"""Model FLOPs of the steps completed in the window over the window at the bf16 peak, in %."""

import readers


def read(w):
    return readers.mfu(w)
