"""reader_ms.read: device milliseconds per question of the operations
launched inside the benchmark's ``predict`` span (the reader's batches
and their span decode) in the traced segment."""


def read(r):
    if r.trace is None or not r.trace_work:
        return None
    us = r.trace.device_us_in(["predict"])
    return us * 1e-3 / r.trace_work if us > 0 else None
