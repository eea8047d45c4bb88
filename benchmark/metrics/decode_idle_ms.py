"""The time a request in which the host was in stylize's decode stage (G's
decode of the warped style vectors: the program's span
``ppst.stylize:decode``) and nothing ran on the device, ms a request of the
traced stretch (``harness.stages``)."""

from harness.stages import idle_ms


def read(run):
    return idle_ms(run, "ppst.stylize:decode")
