"""The time a request in which the host was in stylize's filter stage (the
guided filter on the output, with its clamps and scales: the program's span
``ppst.stylize:filter``) and nothing ran on the device, ms a request of the
traced stretch (``harness.stages``)."""

from harness.stages import idle_ms


def read(run):
    return idle_ms(run, "ppst.stylize:filter")
