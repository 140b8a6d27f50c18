"""Faults planted in the program, for the checks that must catch them: the
CPU tests at a tiny size, and ``control.py --fault`` on the card at a
cell's own size. Each driver names the faults its cells can have
(``faults(traffic) -> {name: (target, make)}``); ``harness.Patches``
plants ``make(original)`` at ``target`` for one run."""
from __future__ import annotations

import numpy as np


def unchanged(orig):
    """A drain that returns its state unchanged: no step is taken."""
    return lambda graph, state, *args, **kwargs: state


def half_batch(orig):
    """A sweep that serves the first half of its roots twice: half of the
    batch left out, its lanes filled with the rest."""
    def sweep(self, roots, *args, **kwargs):
        roots = np.asarray(roots)
        half = roots[:len(roots) // 2]
        return orig(self, np.concatenate([half, half]), *args, **kwargs)
    return sweep


def altered(fix):
    """A function whose result passes through ``fix`` where it is
    produced."""
    def make(orig):
        return lambda *args, **kwargs: fix(orig(*args, **kwargs))
    return make
