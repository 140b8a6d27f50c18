"""The examples on the port (port of the reference's ``examples/``): each
module runs with ``python -m
repro_torch.examples.<name>`` on the GPU, or with ``--device cpu`` on the
plain PyTorch versions, does what the reference's script of the same name
does at its sizes, keeps its asserts, and returns what it printed from
``main``.

  quickstart        the paper's pipeline: hybrid BFS, validation, MS-BFS
  weighted_sssp     delta-stepping lanes, the unit-weight anchor, weighted
                    analytics
  graph_analytics   components, closeness, k-hop and diameter bounds on one
                    LaneEngine, then a khop served by AnalyticsService
  serve_analytics   the async front door, admission, a trace replay
  sweep_trace       a recorded replay: Chrome trace and metrics files
  distributed_bfs   dist_bfs on run_ranks over a (2, 2, 2) mesh of 8 ranks
  gnn_neighbor_sampling  GIN trained on fanout-sampled subgraphs
  train_lm          a reduced LM trained with checkpoints and resume
  serve_lm          the reduced qwen3-moe served: prefill and greedy decode
"""
