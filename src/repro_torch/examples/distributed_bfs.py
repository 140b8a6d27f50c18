"""Multi-rank hybrid BFS on ``torch.distributed`` (port of
``examples/distributed_bfs.py``).

  python -m repro_torch.examples.distributed_bfs [--ndev 8] [--device cpu]

The 1-D partitioned BFS (``core.dist_bfs``) on a ``(pod, data, model)``
mesh of ``--ndev`` ranks, (2, 2, 2) at the default 8 as the reference's 8
host devices; the 1-D engine flattens all axes. ``run_ranks`` starts one
process a rank (NCCL and one GPU a rank on the GPU, so 8 ranks need 8
cards and fewer raise; gloo ranks with ``--device cpu``), the graph handed
over by file. The result is checked against the single-device BFS.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import torch

from repro_torch.core.dist_bfs import dist_bfs, partition_graph
from repro_torch.core.hybrid import bfs
from repro_torch.device import resolve_device
from repro_torch.distributed.ranks import (load_graph, rank_device,
                                           run_ranks, save_graph)
from repro_torch.graph.generator import rmat_graph, sample_roots

AXES = ("pod", "data", "model")


def mesh_shape(ndev: int) -> tuple[int, int, int]:
    """The (pod, data, model) shape of ``ndev`` ranks: factors of 2 go to
    the last axes first, (2, 2, 2) at 8, (1, 2, 2) at 4, (1, 1, 1) at 1;
    the rest goes to "pod"."""
    shape = [1, 1, 1]
    for axis in (2, 1, 0):
        if ndev % 2 == 0 and axis:
            shape[axis], ndev = 2, ndev // 2
    shape[0] *= ndev
    return tuple(shape)


def bfs_rank(graph_path, shape, root, device) -> dict:
    """One rank: ``dist_bfs`` from ``root`` on the ``shape`` mesh, with the
    kernel launches the rank made."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.kernels import common
    dev = rank_device(device)
    g = load_graph(graph_path, dev)
    mesh = init_device_mesh(dev.type, shape, mesh_dim_names=AXES)
    res = dist_bfs(partition_graph(g, mesh.mesh.numel()), root, mesh,
                   "hybrid")
    return dict(parent=res.parent.cpu(), depth=res.depth.cpu(),
                num_layers=int(res.num_layers),
                launches=dict(common.LAUNCHES))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ndev", type=int, default=8,
                    help="ranks (one GPU a rank; gloo ranks with --device "
                         "cpu)")
    ap.add_argument("--device", default=None,
                    help="torch device; default: the GPU (raises without "
                         "one)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    rank_dev = "cpu" if dev.type == "cpu" else None

    g = rmat_graph(12, 16, seed=0, device=dev)
    shape = mesh_shape(args.ndev)
    root = int(sample_roots(g, 1, seed=1)[0])
    with tempfile.TemporaryDirectory(prefix="distributed_bfs_") as tmp:
        path = os.path.join(tmp, "graph.npz")
        save_graph(g, path)
        res = run_ranks(bfs_rank, args.ndev, path, shape, root, rank_dev,
                        device=rank_dev)
    single = bfs(g, root, "hybrid")

    match = bool(torch.equal(res["parent"], single.parent.cpu())
                 and torch.equal(res["depth"], single.depth.cpu()))
    print(f"n={g.n:,} m={g.m:,} root={root}")
    print(f"distributed BFS over {args.ndev} ranks {shape}: "
          f"{res['num_layers']} layers; matches single-device: {match}")
    assert match
    return dict(n=g.n, m=g.m, root=root, shape=shape,
                num_layers=res["num_layers"], match=match,
                rank0_launches=res["launches"])


if __name__ == "__main__":
    main()
