"""encoder_ms.retrieve: device milliseconds per batch of the operations
launched inside the encoder's ranges (the program's ``hop1_encode`` and
``hop2_encode``, or the benchmark's ``encode``) in the traced segment."""


def read(r):
    names = r.extra.get("encode_ranges")
    if r.trace is None or not names or not r.trace_steps:
        return None
    us = r.trace.device_us_in(names)
    return us * 1e-3 / r.trace_steps if us > 0 else None
