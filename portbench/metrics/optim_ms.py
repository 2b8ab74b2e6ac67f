"""Host milliseconds a training step spends in its train.optimizer phase
(AdamW's step, the LR schedule, the EMA and the step's bookkeeping), over
the traced train.step spans."""
from portbench import program_trace

UNIT = "ms"


def read(m, variant: str):
    return program_trace.per_train_step_ms(m, "train.optimizer")
