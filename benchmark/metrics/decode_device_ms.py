"""The device time a request launched in stylize's decode stage (G's decode of
the warped style vectors: the program's span ``ppst.stylize:decode``), ms a
request of the traced stretch (``harness.stages``)."""

from harness.stages import device_ms


def read(run):
    return device_ms(run, "ppst.stylize:decode")
