"""The training kernels (5-7, or 8 and 9 on the store path): the least time
of the layers' forward and backward in the traced stretch
(counts.train_layer_bound) over the device time of the kernels that
kernels/ktrain/ names."""
UNIT = "%"


def read(m, variant: str):
    if m.trace is None or not m.work.get("train_layer_calls"):
        return None
    seconds, launches = m.kernel_seconds("ktrain")
    if not launches:
        return None
    d, f = m.cfg["latent_dim"], m.cfg["ff_size"]
    bound = sum(n * m.counts.train_layer_bound(b, s, d, f)[0]
                for b, s, n in m.work["train_layer_calls"])
    return 100.0 * bound / seconds
