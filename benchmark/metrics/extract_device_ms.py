"""The device time a request launched in stylize's extract stage (E1, E2 and
G's feature pass over [content; style]: the program's span
``ppst.stylize:extract``), ms a request of the traced stretch
(``harness.stages``)."""

from harness.stages import device_ms


def read(run):
    return device_ms(run, "ppst.stylize:extract")
