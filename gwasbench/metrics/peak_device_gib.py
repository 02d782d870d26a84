"""``torch.cuda.max_memory_allocated`` from the start of set-up to the close
of the window, on the fullest card, in GiB."""


def read(run):
    return run.peak_bytes / 2**30 if run.peak_bytes else None
