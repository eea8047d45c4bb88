"""``torch.cuda.max_memory_allocated()`` from before the program's set-up to
the window's end, in GiB."""


def read(run):
    return run.memory_peak_bytes / 2**30
