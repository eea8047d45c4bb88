"""The device time a request launched in stylize's warp stage (the
correspondence, dense or through K3, E2's warp of the style trunk and the
alpha mix: the program's span ``ppst.stylize:warp``), ms a request of the
traced stretch (``harness.stages``)."""

from harness.stages import device_ms


def read(run):
    return device_ms(run, "ppst.stylize:warp")
