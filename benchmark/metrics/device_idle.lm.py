"""The share of the traced stretch with no operation on the device, in %."""

import readers


def read(w):
    return readers.device_idle(w)
