"""Models (port of ``repro.models``): the GNNs (GCN, GIN, EGNN, MACE) and
DIEN so far."""
