"""Tokens of the training tasks completed in the window, per second of it."""

import readers


def read(w):
    return readers.rate(w)
