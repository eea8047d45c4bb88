"""Process start to the window's start: interpreter, imports, inputs,
weights, the program's build and load, the check steps and the warm-up."""


def read(run):
    return run.setup_s
