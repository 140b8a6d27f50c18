"""Direction-optimizing (hybrid) BFS controller, paper Algorithm 3.

A host loop over layers. Each iteration:
  1. computes the heuristic counters on the device, e_f (edges to check
     from the frontier), v_f (frontier vertex count) and e_u (edges from
     unvisited vertices), and reads them back: the layer's one host sync;
  2. applies the switching rule: TD->BU when ``e_f > e_u / alpha``,
     BU->TD when ``v_f < n / beta`` (Beamer et al.);
  3. runs the chosen step;
  4. records the per-layer trace (Table 2 analog).

Modes: hybrid | topdown | bottomup_simd | bottomup_nosimd | hybrid_nosimd
(hybrid with the non-SIMD bottom-up, the paper's blue line in Fig. 3).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.bottomup import (MAX_POS_DEFAULT, bottomup_nosimd_step,
                                       bottomup_simd_step)
from repro_torch.core.csr import CSRGraph, ell_pad
from repro_torch.core.topdown import topdown_ell_step, topdown_step

MAX_TRACE = 64  # fixed trace buffer (Graph500 R-MAT diameters are ~6-10)

ALPHA_DEFAULT = 14.0
BETA_DEFAULT = 24.0

MODES = ("hybrid", "topdown", "bottomup_simd", "bottomup_nosimd",
         "hybrid_nosimd")


class BFSResult(NamedTuple):
    # All int32, as in the reference: values are bounded by m, and
    # ``from_edges`` rejects graphs with m >= 2**31.
    parent: torch.Tensor           # int32[n], -1 unreached, parent[root]=root
    depth: torch.Tensor            # int32[n], -1 unreached
    num_layers: torch.Tensor       # int32 scalar
    edges_traversed: torch.Tensor  # int32 scalar: 2x undirected component edges
    trace_dir: torch.Tensor        # int32[MAX_TRACE]: 0 TD, 1 BU, -1 unused
    trace_vf: torch.Tensor         # int32[MAX_TRACE]
    trace_ef: torch.Tensor         # int32[MAX_TRACE]
    trace_eu: torch.Tensor         # int32[MAX_TRACE]


def switch_direction(topdown, e_f, v_f, e_u, n: int,
                     alpha: float = ALPHA_DEFAULT,
                     beta: float = BETA_DEFAULT):
    """Paper Algorithm 3 switching rule (Beamer et al.), one layer.

    TD->BU when ``e_f > e_u / alpha``; BU->TD when ``v_f < n / beta``;
    otherwise keep the current direction. Arguments are host scalars or
    numpy arrays; returns the new ``topdown`` flag(s).

    The rule is evaluated in float32, as the reference does. XLA compiles
    the reference's division by the static ``alpha`` into a multiplication
    by its float32 reciprocal, and so does this function, so that both take
    the same branch where ``e_u / alpha`` rounds differently.
    """
    f32 = np.float32
    topdown = np.asarray(topdown, dtype=bool)
    go_bu = topdown & (np.asarray(e_f, f32)
                       > np.asarray(e_u, f32) * (f32(1) / f32(alpha)))
    go_td = ~topdown & (np.asarray(v_f, f32) < f32(n) / f32(beta))
    return np.where(go_bu, False, np.where(go_td, True, topdown))


def bfs(g: CSRGraph, root: int, mode: str = "hybrid",
        alpha: float = ALPHA_DEFAULT, beta: float = BETA_DEFAULT,
        max_pos: int = MAX_POS_DEFAULT, skip_empty_fallback: bool = True,
        td_impl: str = "edge") -> BFSResult:
    """Run a full BFS from ``root`` on the graph's device."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")
    if td_impl not in ("edge", "ell"):
        raise ValueError(f"unknown td_impl {td_impl!r}")
    n, dev = g.n, g.device
    root = int(root)
    deg = g.deg
    frontier = torch.zeros(n, dtype=torch.bool, device=dev)
    frontier[root] = True
    visited = frontier.clone()
    parent = torch.full((n,), -1, dtype=torch.int32, device=dev)
    parent[root] = root
    depth = torch.full((n,), -1, dtype=torch.int32, device=dev)
    depth[root] = 0
    # beyond-paper ELL top-down: bounded adjacency slabs, built once per BFS
    ell = ell_pad(g, 16) if td_impl == "ell" else None
    topdown = mode not in ("bottomup_simd", "bottomup_nosimd")
    trace = np.zeros((4, MAX_TRACE), dtype=np.int32)  # dir, v_f, e_f, e_u
    trace[0] = -1
    layer = 0
    while layer < MAX_TRACE:
        counts = torch.stack([frontier.sum(),
                              torch.where(frontier, deg, 0).sum(),
                              torch.where(visited, 0, deg).sum()])
        v_f, e_f, e_u = counts.tolist()
        if v_f == 0:
            break
        if mode == "topdown":
            topdown = True
        elif mode in ("bottomup_simd", "bottomup_nosimd"):
            topdown = False
        else:
            topdown = bool(switch_direction(topdown, e_f, v_f, e_u, n, alpha,
                                            beta))
        if topdown and td_impl == "ell":
            step = topdown_ell_step(g, ell, frontier, visited, parent, k_max=16)
        elif topdown:
            step = topdown_step(g, frontier, visited, parent)
        elif mode in ("bottomup_nosimd", "hybrid_nosimd"):
            step = bottomup_nosimd_step(g, frontier, visited, parent)
        else:
            step = bottomup_simd_step(g, frontier, visited, parent, max_pos,
                                      skip_empty_fallback)
        frontier, visited, parent = step
        depth = torch.where(frontier, layer + 1, depth)
        trace[:, layer] = (0 if topdown else 1, v_f, e_f, e_u)
        layer += 1
    edges = torch.where(visited, deg, 0).sum().to(torch.int32)
    trace_dir, trace_vf, trace_ef, trace_eu = torch.from_numpy(trace).to(dev)
    return BFSResult(parent=parent, depth=depth,
                     num_layers=torch.tensor(layer, dtype=torch.int32,
                                             device=dev),
                     edges_traversed=edges, trace_dir=trace_dir,
                     trace_vf=trace_vf, trace_ef=trace_ef, trace_eu=trace_eu)
