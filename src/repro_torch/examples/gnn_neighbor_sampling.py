"""Neighbour-sampled GNN training, the minibatch_lg pipeline end to end
(port of ``examples/gnn_neighbor_sampling.py``).

  python -m repro_torch.examples.gnn_neighbor_sampling [--device cpu]

The sampler is capped BFS frontier expansion (the paper's probe gather with
random positions); every step samples a fresh subgraph of 64 seeds at
fanout (5, 3) from a scale-12 Graph500 graph and takes one GIN training
step on it (AdamW, no clipping, as the reference's script). On the GPU (the
default) GIN's neighbour sums launch the ELL kernels; features, labels,
seeds and draws come from a generator on the device, so the values are not
the reference's, the sizes and the loop are.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.device import resolve_device
from repro_torch.graph.generator import rmat_graph
from repro_torch.graph.sampler import dedup_count, sampled_graph_batch
from repro_torch.models.gnn.gin import GINConfig, gin_loss, init_gin
from repro_torch.optim.adamw import OptConfig, adamw_update, init_opt_state

STEPS, BATCH_NODES, FANOUT = 30, 64, (5, 3)
SCALE, EDGEFACTOR, N_CLASSES = 12, 8, 6


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device; default: the GPU (raises without "
                         "one)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    g = rmat_graph(SCALE, EDGEFACTOR, seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    feats = torch.randn((g.n, 16), generator=gen, device=dev)
    labels = torch.randint(0, N_CLASSES, (g.n,), generator=gen,
                           dtype=torch.int32, device=dev)

    cfg = GINConfig(d_feat=16, d_hidden=32, n_layers=2, n_classes=N_CLASSES,
                    task="node")
    params = {k: v.to(dev) for k, v in init_gin(
        torch.Generator().manual_seed(2), cfg).items()}
    opt_cfg = OptConfig(lr=3e-3)
    opt = init_opt_state(params, opt_cfg)

    def step(params, opt, gb):
        leaves = {k: p.detach().requires_grad_(True)
                  for k, p in params.items()}
        loss, _ = gin_loss(leaves, gb, cfg)
        grads = dict(zip(leaves, torch.autograd.grad(
            loss, list(leaves.values()))))
        params, opt = adamw_update(params, grads, opt, opt_cfg)
        return params, opt, loss.detach()

    print(f"graph n={g.n:,} m={g.m:,}; sampling {BATCH_NODES} seeds x "
          f"fanout {FANOUT} per step")
    losses, rows = [], []
    for i in range(STEPS):
        gen.manual_seed(100 + i)
        seeds = torch.randperm(g.n, generator=gen, device=dev)[:BATCH_NODES]
        gb = sampled_graph_batch(gen, g, seeds.to(torch.int32), feats,
                                 labels, fanout=FANOUT, n_classes=N_CLASSES)
        params, opt, loss = step(params, opt, gb)
        losses.append(float(loss))
        if i % 10 == 0 or i == STEPS - 1:
            uniq = int(dedup_count(seeds.to(torch.int32), g.n))
            rows.append(dict(step=i, loss=losses[-1],
                             subgraph_nodes=gb.n_nodes, unique_seeds=uniq))
            print(f"step {i:3d} loss={losses[-1]:.4f} "
                  f"subgraph_nodes={gb.n_nodes} unique_seeds={uniq}")
    print("done")
    return dict(n=g.n, m=g.m, steps=STEPS, losses=losses, rows=rows)


if __name__ == "__main__":
    main()
