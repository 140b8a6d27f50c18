"""Collectives and launch support of the distributed engines (port of
``repro.distributed``): the frontier-word codec (``compression``) and the
rank launcher (``ranks``), which stands in for the reference's forced host
devices."""
