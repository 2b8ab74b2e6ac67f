"""Host milliseconds of one denoiser call: the mean of the program's denoiser
spans (embedding, the fused layers, the head), from the call to its return,
over the traced stretch."""
from portbench import program_trace

UNIT = "ms"


def read(m, variant: str):
    r = program_trace.records(m)
    if r is None or not r.n("denoiser"):
        return None
    return r.total_ms("denoiser") / r.n("denoiser")
