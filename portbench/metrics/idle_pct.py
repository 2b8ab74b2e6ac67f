"""Share of the traced stretch in which no operation ran on the device: one
minus the union of the profiler's device intervals over the stretch."""
UNIT = "%"


def read(m, variant: str):
    t = m.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
