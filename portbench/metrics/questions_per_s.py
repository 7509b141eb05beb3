"""questions_per_s: questions whose results reached the host in the
window, over the window's seconds (its first step's start to its last
step's end)."""


def read(r):
    return r.work / r.elapsed if r.elapsed > 0 else None
