"""The flash backward kernels' (dq and dkv) bound over their device time in the traced stretch, in %."""

import readers


def read(w):
    return readers.kernel_roofline(w, ("dq", "dkv"))
