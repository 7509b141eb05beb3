"""setup_s: seconds from the process's start to the first timed step
(inputs and weights made, the program built, every shape warmed up)."""


def read(r):
    return r.setup_s
