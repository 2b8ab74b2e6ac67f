"""Host milliseconds the training loop waits for each batch: the harness's
span around the loader's next()."""
UNIT = "ms"


def read(m, variant: str):
    s = m.spans
    if s is None or not s.count.get("portbench.loader"):
        return None
    return 1e3 * s.total["portbench.loader"] / s.count["portbench.loader"]
