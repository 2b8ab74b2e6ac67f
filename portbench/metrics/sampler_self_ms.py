"""Host milliseconds a denoising step spends in the sampler's own work: the
program's sampler.step spans less their denoiser children, over the steps
traced (the noise draws, the update, the x0 blend and the launches
between)."""
from portbench import program_trace

UNIT = "ms"


def read(m, variant: str):
    r = program_trace.records(m)
    steps = m.work.get("steps", 0)
    if r is None or not r.n("sampler.step") or not steps:
        return None
    return r.self_ms("sampler.step", "denoiser") / steps
