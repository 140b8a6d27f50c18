"""Fanout neighbour sampler: capped BFS frontier expansion (port of
``repro/graph/sampler.py``).

Produces the ``minibatch_lg`` training subgraph: seed batch -> sample up to
``fanout[0]`` neighbours per seed (layer 1) -> ``fanout[1]`` per layer-1
node (layer 2). This *is* the paper's frontier expansion with a per-vertex
probe budget: sampling position ``r`` in a row is exactly the bottom-up
LoadAdj gather with a random ``pos`` instead of a sequential one, and the
visited-dedup count reuses the core bitmaps. Shapes depend only on the seed
count and the fanouts (with-replacement sampling, masked rows for isolated
vertices: GraphSAGE semantics).

A ``torch.Generator`` on the graph's device draws the positions; ``draws=``
hands in the raw draws instead (one int tensor [F, fanout] a layer, values
in [0, 2**30)), which is how the tests feed the reference's draws through.
"""
from __future__ import annotations

import torch

from repro_torch.analytics.khop import khop_neighborhood
from repro_torch.core import bitmap
from repro_torch.core.csr import CSRGraph
from repro_torch.models.gnn.common import GraphBatch


def _sample_layer(gen, g: CSRGraph, frontier: torch.Tensor, fanout: int,
                  draws: torch.Tensor | None = None):
    """frontier int32[F] -> (neigh int32[F, fanout], valid bool[F, fanout])."""
    f = frontier.long()
    deg = g.deg[f]
    starts = g.row_ptr[f]
    if draws is None:
        draws = torch.randint(0, 1 << 30, (f.shape[0], fanout), generator=gen,
                              dtype=torch.int32, device=g.device)
    pos = draws.to(torch.int32) % torch.clamp(deg, min=1)[:, None]
    idx = torch.clamp(starts[:, None] + pos, 0, g.m - 1)
    neigh = g.col_idx[idx.long()]                # the LoadAdj gather
    valid = (deg > 0)[:, None].expand(f.shape[0], fanout)
    return neigh, valid


def sample_subgraph(gen, g: CSRGraph, seeds: torch.Tensor,
                    fanout: tuple[int, ...] = (15, 10), draws=None):
    """Returns (nodes int32[N_sub], senders, receivers, edge_mask) where
    edges point sampled-neighbour -> requesting node (message direction),
    in *local subgraph coordinates*; node ids are original graph ids.

    Layout: [seeds | layer1 | layer2 | ...]; layer l node j's slot is
    deterministic, so shapes are static for any seed batch.
    """
    dev = g.device
    frontier = seeds.to(device=dev, dtype=torch.int32)
    layers = [frontier]
    senders, receivers, masks = [], [], []
    offset = 0
    for li, f in enumerate(fanout):
        neigh, valid = _sample_layer(gen, g, frontier, f,
                                     None if draws is None else draws[li])
        n_f = frontier.shape[0]
        next_offset = offset + n_f
        ar = torch.arange(n_f, dtype=torch.int32, device=dev)
        receivers.append(torch.repeat_interleave(ar + offset, f))
        senders.append(torch.arange(n_f * f, dtype=torch.int32, device=dev)
                       + next_offset)
        masks.append(valid.reshape(-1))
        frontier = neigh.reshape(-1)
        layers.append(frontier)
        offset = next_offset
    return (torch.cat(layers), torch.cat(senders), torch.cat(receivers),
            torch.cat(masks))


def sampled_graph_batch(gen, g: CSRGraph, seeds, feats, labels,
                        fanout=(15, 10), n_classes: int = 41,
                        draws=None) -> GraphBatch:
    """A GraphBatch for the GNN train step from a sampled subgraph;
    features and labels gathered from the full-graph arrays."""
    nodes, senders, receivers, edge_mask = sample_subgraph(
        gen, g, seeds, tuple(fanout), draws)
    idx = nodes.long()
    return GraphBatch(
        senders=senders, receivers=receivers, edge_mask=edge_mask,
        feats=feats[idx],
        pos=torch.zeros((nodes.shape[0], 3), dtype=torch.float32,
                        device=nodes.device),
        labels=labels[idx], node_mask=torch.ones_like(nodes, dtype=torch.bool),
        graph_ids=torch.zeros_like(nodes), n_graphs=1)


def khop_node_sets(g, seeds, k: int, **engine_kwargs):
    """Each seed's complete depth <= k neighbourhood, from ONE lane sweep
    of the packed MS-BFS engine (``analytics.khop``).

    Where ``sample_subgraph`` draws a *bounded random* neighbourhood
    (fanout caps, with replacement), this returns each seed's *complete*
    neighbourhood. Returns ``(node_sets, khop_result)``: ``node_sets[i]``
    is the ascending int64 vertex-id array within ``k`` hops of
    ``seeds[i]`` (seed included); ``khop_result`` keeps the packed words,
    counts and depths. ``engine_kwargs`` pass through to the analytics
    ``LaneEngine`` (``lanes=``, ...).
    """
    res = khop_neighborhood(g, seeds, k, **engine_kwargs)
    sets = [res.members(i) for i in range(res.sources.size)]
    return sets, res


def dedup_count(nodes: torch.Tensor, n_total: int) -> torch.Tensor:
    """Unique-vertex count through the core bitmap (instrumentation: the
    sampling's redundancy, measured as the BFS visited bitmap would)."""
    words = torch.zeros((bitmap.num_words(n_total),), dtype=torch.int32,
                        device=nodes.device)
    return bitmap.popcount_words(bitmap.set_bits(words, nodes))
