"""Uniform result metadata of the analytics layer (port of
``repro.analytics.meta``, copied: the port imports nothing of ``repro``).

Every analytics ``*Result`` carries a ``QueryMeta``: layers or steps
consumed, the lane-pool width, the sweep count, the partition, the
truncation flag, and exchange bytes when a distributed engine metered them.
Workload-specific facts (delta, chunk size, ...) live under ``extra``.

The reference's dict spellings (``res.meta["ndev"]``,
``res.meta["weighted"]``) keep working: ``QueryMeta`` answers
``__getitem__``/``get``/``in`` over the common fields merged with the
extras, with a ``DeprecationWarning`` pointing at the attribute form.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass, field, fields

__all__ = ["QueryMeta"]


@dataclass(frozen=True)
class QueryMeta:
    """Common metadata carried by every analytics ``*Result``."""
    kind: str = ""               # query tag (api.QUERY_KINDS key)
    layers: int = 0              # engine layers/steps consumed
    truncated: bool = False      # any lane hit its step/layer cap
    lanes: int = 0               # lane-pool width the sweep(s) ran with
    sweeps: int = 1              # engine sweeps issued
    ndev: int = 1                # devices the engine partitioned over
    exch_bytes: int | None = None  # exchange volume, when metered
    extra: dict = field(default_factory=dict)

    def as_dict(self) -> dict:
        """Flat dict view: common fields merged with ``extra`` (extras
        win on collision — they are the workload's own spelling)."""
        out = {f.name: getattr(self, f.name) for f in fields(self)
               if f.name != "extra"}
        out.update(self.extra)
        return out

    # -- deprecated dict-style access (the pre-QueryMeta spellings) -------
    def _warn(self, key):
        warnings.warn(
            f"dict-style access to QueryMeta ({key!r}) is deprecated — "
            f"use the attribute form (meta.{key} for common fields, "
            f"meta.extra[{key!r}] for workload extras)",
            DeprecationWarning, stacklevel=3)

    def __getitem__(self, key):
        self._warn(key)
        return self.as_dict()[key]

    def get(self, key, default=None):
        self._warn(key)
        return self.as_dict().get(key, default)

    def __contains__(self, key) -> bool:
        return key in self.as_dict()

    def keys(self):
        return self.as_dict().keys()
