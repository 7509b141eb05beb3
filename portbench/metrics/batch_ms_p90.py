"""batch_ms_p90: the 90th percentile, over every batch of the window, of
the host milliseconds from a batch's token ids to its results on the
host."""

import numpy as np


def read(r):
    if len(r.window) < 10:
        return None
    return 1e3 * float(np.percentile([s for s, _ in r.window], 90))
