"""idle_share.retrieve: the share of the traced window in which no operation
runs on the card, in percent: one minus the device's busy seconds
(profiler timeline, overlapping operations counted once) over the
window's seconds, both of the segment profiled on the device alone (the
result's ``busy_s`` / ``window_s``), whose host runs at its untraced
cadence."""


def read(r):
    if not r.busy_s or not r.busy_window_s:
        return None
    return 100.0 * (1.0 - r.busy_s / r.busy_window_s)
