"""The time a request in which the host was in stylize's warp stage (the
correspondence, dense or through K3, E2's warp of the style trunk and the
alpha mix: the program's span ``ppst.stylize:warp``) and nothing ran on the
device, ms a request of the traced stretch (``harness.stages``)."""

from harness.stages import idle_ms


def read(run):
    return idle_ms(run, "ppst.stylize:warp")
