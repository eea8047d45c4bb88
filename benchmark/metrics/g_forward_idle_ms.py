"""The time a G step in which the host was in its forward phase (the batch's
cast, the losses and their sum: the program's span ``ppst.step:forward``)
and nothing ran on the device, ms a G step of the traced stretch
(``harness.stages``)."""

from harness.stages import idle_ms


def read(run):
    return idle_ms(run, "ppst.step:forward", kinds=("G",))
