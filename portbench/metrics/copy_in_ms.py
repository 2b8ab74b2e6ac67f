"""Host milliseconds a training step spends in its train.copy_in phase (the
batch to the device and the loss-aware sampler's read-back), over the
traced train.step spans."""
from portbench import program_trace

UNIT = "ms"


def read(m, variant: str):
    return program_trace.per_train_step_ms(m, "train.copy_in")
