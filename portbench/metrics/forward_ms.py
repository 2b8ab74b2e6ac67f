"""Host milliseconds a training step spends in its train.forward phase
(timestep draws, q_sample, the condition mask, the denoiser and the loss),
over the traced train.step spans."""
from portbench import program_trace

UNIT = "ms"


def read(m, variant: str):
    return program_trace.per_train_step_ms(m, "train.forward")
