"""The time a G step in which the host was in its update phase (the Adam steps
and the RSCL queues: the program's span ``ppst.step:update``) and nothing
ran on the device, ms a G step of the traced stretch (``harness.stages``)."""

from harness.stages import idle_ms


def read(run):
    return idle_ms(run, "ppst.step:update", kinds=("G",))
