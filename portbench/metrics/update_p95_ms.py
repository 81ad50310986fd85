"""The 95th percentile of the latency of every increment of the window
(update, commit and host read), in ms."""

import numpy as np


def read(rec):
    lat = rec.timed.spans["increment"]
    return float(np.percentile(lat, 95)) * 1e3 if lat else None
