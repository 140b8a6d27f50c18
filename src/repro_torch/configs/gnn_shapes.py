"""Shared GNN shape contract (port of ``repro/configs/gnn_shapes.py``).

  full_graph_sm : cora-scale full-batch (n=2,708 e=10,556 d=1,433)
  minibatch_lg  : reddit-scale sampled training step input, from
                  batch_nodes=1,024 with fanout 15-10 (1,024 + 15,360 +
                  153,600 nodes; 168,960 edges; d=602)
  ogb_products  : full-batch-large (n=2,449,029 e=61,859,140 d=100)
  molecule      : 128 packed molecular graphs (30 nodes / 64 edges each)
"""
from repro_torch.configs.base import Shape

MINIBATCH_NODES = 1024 + 1024 * 15 + 1024 * 15 * 10     # 169,984
MINIBATCH_EDGES = 1024 * 15 + 1024 * 15 * 10            # 168,960


def gnn_shapes() -> tuple[Shape, ...]:
    return (
        Shape("full_graph_sm", "train",
              dims=dict(n_nodes=2708, n_edges=10556, d_feat=1433,
                        n_classes=7)),
        Shape("minibatch_lg", "train",
              dims=dict(n_nodes=MINIBATCH_NODES, n_edges=MINIBATCH_EDGES,
                        d_feat=602, n_classes=41,
                        full_nodes=232965, full_edges=114615892,
                        batch_nodes=1024, fanout=(15, 10))),
        Shape("ogb_products", "train",
              dims=dict(n_nodes=2449029, n_edges=61859140, d_feat=100,
                        n_classes=47)),
        Shape("molecule", "train",
              dims=dict(n_nodes=30 * 128, n_edges=64 * 128, d_feat=64,
                        n_classes=16, n_graphs=128)),
    )
