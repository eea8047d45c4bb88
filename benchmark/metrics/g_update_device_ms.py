"""The device time a G step launched in its update phase (the Adam steps and
the RSCL queues: the program's span ``ppst.step:update``), ms a G step of
the traced stretch (``harness.stages``)."""

from harness.stages import device_ms


def read(run):
    return device_ms(run, "ppst.step:update", kinds=("G",))
