"""answers_per_s: questions answered (answer and supporting facts
decoded) in the window, over the window's seconds."""


def read(r):
    return r.work / r.elapsed if r.elapsed > 0 else None
