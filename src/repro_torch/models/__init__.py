"""Models (port of ``repro.models``): the GNNs (GCN, GIN, EGNN, MACE),
DIEN, and the decoder LMs with their MoE FFN."""
