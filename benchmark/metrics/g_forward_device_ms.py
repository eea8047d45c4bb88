"""The device time a G step launched in its forward phase (the batch's cast,
the losses and their sum: the program's span ``ppst.step:forward``), ms a G
step of the traced stretch (``harness.stages``)."""

from harness.stages import device_ms


def read(run):
    return device_ms(run, "ppst.step:forward", kinds=("G",))
