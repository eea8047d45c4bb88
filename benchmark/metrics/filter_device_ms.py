"""The device time a request launched in stylize's filter stage (the guided
filter on the output, with its clamps and scales: the program's span
``ppst.stylize:filter``), ms a request of the traced stretch
(``harness.stages``)."""

from harness.stages import device_ms


def read(run):
    return device_ms(run, "ppst.stylize:filter")
