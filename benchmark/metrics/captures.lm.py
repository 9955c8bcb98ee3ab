"""CUDA-graph captures in the window (the program's ``capture`` entries;
the set-up takes the variant's one). Nothing where the program counts no
captures."""


def read(w):
    if "capture" not in w.counts1:
        return None
    return float(w.phase_n("capture"))
