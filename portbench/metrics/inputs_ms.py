"""Host milliseconds a sampler call spends putting its inputs on the device:
the program's sampler.inputs span (Sampler.__call__'s staging of the
content, the condition, the inpainting mask and motion, pinned noise)."""
from portbench import program_trace

UNIT = "ms"


def read(m, variant: str):
    return program_trace.per_call_ms(m, "sampler.inputs")
