"""peak_gb: the device allocator's peak over the window
(``torch.cuda.max_memory_allocated`` after a reset at its start),
resident data included, in GB."""


def read(w):
    return w.peak_bytes / 1e9
