"""Megabytes (10^6 bytes) a sampler call copies from host arrays to the
device: the program's copy.h2d_bytes counter over the traced calls."""
from portbench import program_trace

UNIT = "MB"


def read(m, variant: str):
    r = program_trace.records(m)
    counted = None if r is None else r.counted("copy.h2d_bytes")
    if counted is None or not program_trace.calls(m):
        return None
    return counted / 1e6 / program_trace.calls(m)
