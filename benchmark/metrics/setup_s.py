"""Seconds from the process's start to the window's."""


def read(w):
    return w.setup_s
