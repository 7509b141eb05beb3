"""featurize_ms.read: host milliseconds per question spent in the
benchmark's span around the reader dataset's featurization
(``QADataset`` items, built as ``predict`` asks for them) in the
measured window."""


def read(r):
    s = r.extra.get("featurize_s")
    if s is None or not r.work:
        return None
    return 1e3 * s / r.work
