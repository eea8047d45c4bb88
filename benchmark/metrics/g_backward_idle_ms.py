"""The time a G step in which the host was in its backward phase (zeroing, the
backward with its recomputes, zero-fill: the program's span
``ppst.step:backward``) and nothing ran on the device, ms a G step of the
traced stretch (``harness.stages``)."""

from harness.stages import idle_ms


def read(run):
    return idle_ms(run, "ppst.step:backward", kinds=("G",))
