"""setup_s: the seconds from the command's first line to the window's
start: imports, the card's context, the data made on the card, the
program built and its kernels loaded (a checkout's first run builds
them), the warm-up, the check's buffers."""


def read(w):
    return w.setup_s
