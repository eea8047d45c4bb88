"""The device time a G step launched in its backward phase (zeroing, the
backward with its recomputes, zero-fill: the program's span
``ppst.step:backward``), ms a G step of the traced stretch
(``harness.stages``)."""

from harness.stages import device_ms


def read(run):
    return device_ms(run, "ppst.step:backward", kinds=("G",))
