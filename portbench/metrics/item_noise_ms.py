"""Host milliseconds a sampler call spends drawing its per-item noise: the
program's sampler.item_noise span (a generator and a draw a clip)."""
from portbench import program_trace

UNIT = "ms"


def read(m, variant: str):
    return program_trace.per_call_ms(m, "sampler.item_noise")
