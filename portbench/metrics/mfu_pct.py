"""The denoiser's algorithmic operations completed in the traced stretch
(counts.denoiser_flops at the calls' shapes; training: the forward and a
backward of twice its work; the text tower not counted) over the stretch's
length at the card's bf16 peak."""
UNIT = "%"


def read(m, variant: str):
    t = m.trace
    flops = m.work.get("flops", 0)
    if t is None or t.window_s <= 0 or not flops:
        return None
    return 100.0 * flops / (t.window_s * m.counts.PEAK_BF16_FLOPS)
