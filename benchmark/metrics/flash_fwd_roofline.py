"""The flash forward kernel's bound over its device time in the traced stretch, in %."""

import readers


def read(w):
    return readers.kernel_roofline(w, ("fwd",))
