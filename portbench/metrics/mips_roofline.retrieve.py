"""mips_roofline.retrieve: the least time the traced segment's searches
need (``portbench/roofline.py``: max(bytes / 3.35 TB/s, operations /
peak) per call, the work counted from the call's shapes and, for a
rescan, the chunks its results lie in) over the device time of the
operations launched inside the search's ranges, in percent."""


def read(r):
    names, least = r.extra.get("mips_ranges"), r.extra.get("mips_least_s")
    if r.trace is None or not names or not least:
        return None
    us = r.trace.device_us_in(names)
    return 100.0 * least / (us * 1e-6) if us > 0 else None
