"""The time a request in which the host was in stylize's extract stage (E1, E2
and G's feature pass over [content; style]: the program's span
``ppst.stylize:extract``) and nothing ran on the device, ms a request of the
traced stretch (``harness.stages``)."""

from harness.stages import idle_ms


def read(run):
    return idle_ms(run, "ppst.stylize:extract")
