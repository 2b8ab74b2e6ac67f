"""Host milliseconds a denoising step spends in the sampler outside the
denoiser call: the harness's span around each sampler call, less its spans
around the model function it hands in, over the steps traced."""
UNIT = "ms"


def read(m, variant: str):
    s = m.spans
    steps = m.work.get("steps", 0)
    if s is None or not steps or not s.count.get("portbench.sampler"):
        return None
    outside = s.total["portbench.sampler"] - s.total.get("portbench.denoiser", 0.0)
    return 1e3 * outside / steps
