"""The device memory the window's calls held at most, in GiB
(``torch.cuda.max_memory_allocated`` after ``reset_peak_memory_stats`` at
the window's start); None off the card."""


def read(run):
    return run.peak_bytes / 2 ** 30 if run.peak_bytes else None
