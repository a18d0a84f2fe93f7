"""The 95th percentile, in ms, of the latencies of every request completed
in the window: from its batch's submission to its result on the host."""

import numpy as np


def read(run):
    lat = [x for w in run.works for x in w.get("latencies_s", [])]
    return 1e3 * float(np.percentile(lat, 95)) if lat else None
