"""The 95th percentile of a call's wall time, from the call until its clips
are on the host, over every call of the traced run's window (the profiler
records the device only, for the first calls)."""
import numpy as np

UNIT = "ms"


def read(m, variant: str):
    lat = m.work.get("call_ms")
    return float(np.percentile(lat, 95)) if lat else None
