"""95th percentile of the windows' latencies (start of the submit call to
the return of ``get_arrays()``), over every window of the measured window,
with their count beside it."""

import numpy as np


def read(ctx):
    lat = ctx["timed"]["latencies_s"]
    if not lat:
        return None
    return {"value": float(np.percentile(lat, 95)) * 1e3, "windows": len(lat)}
