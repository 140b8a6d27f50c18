"""teps.depths: the Graph500 edges of every traversal of the window's
requests (each request's ``edges``, counted by the benchmark from its
own graph), over the window's seconds; the window holds whole requests
only."""


def read(w):
    return sum(r.work["edges"] for r in w.records) / w.seconds
