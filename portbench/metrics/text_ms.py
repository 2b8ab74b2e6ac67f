"""Host milliseconds a training step spends in the text tower's front: the
program's text.encode span (the caption memo's lookups, the tower on the
distinct misses), over the traced train.step spans."""
from portbench import program_trace

UNIT = "ms"


def read(m, variant: str):
    return program_trace.per_train_step_ms(m, "text.encode")
