"""Kernel 1 (the fused inference layer): the least time of its layer calls
in the traced stretch (counts.layer_bound at each call's rows and tokens)
over the device time of the kernels that kernels/k1/ names."""
UNIT = "%"


def read(m, variant: str):
    if m.trace is None or not m.work.get("layer_calls"):
        return None
    seconds, launches = m.kernel_seconds("k1")
    if not launches:
        return None
    d, f = m.cfg["latent_dim"], m.cfg["ff_size"]
    bound = sum(n * m.counts.layer_bound(b, s, d, f)[0] for b, s, n in m.work["layer_calls"])
    return 100.0 * bound / seconds
