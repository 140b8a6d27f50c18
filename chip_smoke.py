#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

  python3 chip_smoke.py [--scale 20] [--roots 64] [--sources 32]
                        [--reps 20] [--out DIR]

Run from the repository root. The graph is Graph500 R-MAT at edgefactor 16
from seed 0, with uniform (0, 1) edge weights; its unweighted view is the
BFS phases' graph. --scale, --roots, --sources and --reps cut a quick check
short; --out DIR also writes the per-step rows of sssp_layers there. Each
phase prints one JSON line:
  device   the card, as torch and nvidia-smi name it, with its power limit;
  build    the CUDA kernels compiled from src/repro_torch/csrc/*.cu (sm_90a);
  graph    the weighted Graph500 R-MAT graph built on the card;
  kernel   each kernel against its plain PyTorch version on the card, on a
           seeded random visited/frontier split and on every layer state of
           one hybrid BFS: outputs must be bit-equal; times from CUDA events;
  layers   where one hybrid BFS spends its time, layer by layer (the
           top-down scan timed on each top-down layer and the bottom-up
           probe on each bottom-up layer, each beside its bound);
  main     the serial Graph500 harness (hybrid, all roots) through
           run_graph500, with the launch counts of that run alone, then the
           validator, the numpy oracle and the cross-mode checks;
  msbfs_kernel    the multi-source kernels (msbfs_probe, segment_or)
           against their plain versions on seeded random lane words (W = 2,
           8 and 16) and on every layer state of one batched sweep;
  batched_layers  where that sweep (one lane per root) spends its time,
           layer by layer, with the host syncs of a step, msbfs_probe and
           segment_or's two forms each beside its bound, then the parent
           derivation;
  parents_kernel  the parent derivation kernel (X5) at the parents
           cell's shape, on the depths of one drained 64-root sweep:
           bit-equal to its plain version (the chunked library gathers
           and scatter-min the port ran before, so also the library
           time), both timed
           (median, cold L2) with the narrowing and scan passes apart,
           beside its bound, with its launches a call and both peaks;
  batched  the batched Graph500 harness (run_graph500 batched=True, 64
           lanes) with the launch counts of that run alone, then every
           lane against the serial bfs, traces, validator and oracle, and
           a run with 4x the roots through the same 64 lanes (refills);
  sssp_kernel     the relax kernels (semiring_relax, relax_fallback)
           against their plain versions on seeded random lane values (L =
           1, 3 and 32, a quarter of the sources active) under the light
           and heavy weight masks of default_delta, and on the phase inputs
           of the first steps (and every 20th) of one sweep; both timed on
           the random L = 32 heavy input and on the sweep's light and heavy
           inputs;
  sssp_layers     where that sweep (32 sources in 32 lanes) spends its
           time, step by step, with the host syncs of a step;
  sssp     the delta-stepping engine through sssp_pipelined (32 sources in
           32 lanes), with the launch counts of that run alone, then twice
           the sources through the same lanes (refills) against it, 4 lanes
           against scipy's Dijkstra, the unit-weight anchor against
           msbfs_pipelined, and the sssp_teps points;
  gnn_kernel      the GCN aggregation kernels: ell_spmm bit-equal to its
           float32 plain version, both within float32's summation bound of
           their plain versions taken in float64, on a seeded
           ogb_products-shaped batch's graph and its transpose (d = 16,
           timed, and 47), a row subset of it at d = 100, and the R-MAT
           graph at d = 16 (hub rows: long residue tails); then the batch
           with a quarter of its edges masked (dead slots past row_ptr[n]
           in the fixed-size CSR) at d = 100: each CSR's live part equal to
           the nonzero CSR's (nonzero_csr), both kernels bit-equal to their
           plain versions (the residue in slot order) and to the kernels
           over the nonzero CSR;
  gcn_layers      where one gcn-cora training step at ogb_products spends
           its time (data, CSR + ELL build, forward, backward, optimizer,
           one step under torch.profiler, as for the zoo below), the
           kernels' launches and ms in a step, its host syncs beside the
           nonzero adjacency's (2 more an adjacency build), the
           adjacency build and the step over both in turns; on a masked
           batch the step's loss and gradients bit-equal over both
           adjacencies and the kernels, as in gnn_kernel, at the step's
           four shapes;
  gcn_train       the Trainer on gcn-cora at ogb_products (1 warm-up and 5
           timed steps) with the launch counts of that run alone (4 of
           ell_spmm a step, and spmm_residue's kernels: a row and a segment
           pass per column block and a merge, 3 a call at d <= 128, 12 a
           step), then one step on the kernels against the plain
           aggregation on the same card, and kill-and-resume at
           full_graph_sm (exact);
  gnn_zoo  the rest of the GNN zoo: ell_spmm and spmm_residue on GIN's
           inputs (ogb_products d = 100 and 64, the transposed graph at
           64, minibatch_lg d = 602, full_graph_sm d = 1433), each
           bit-equal to its float32 plain version (the residue's plain
           version summed in slot order, as the kernel's row pass sums
           tails of at most 64 slots) and timed beside its bound; the
           Trainer on gin-tu at ogb_products (1 warm-up and 5 timed steps)
           and full_graph_sm with the launches of each run (5 forward and
           4 backward calls of each kernel a step: 9 launches of ell_spmm,
           27 and 49 of spmm_residue, whose call at d_feat = 1433 is 12
           column passes), one ogb_products step on the
           kernels against the plain aggregation; the Trainer on egnn and
           mace (bfloat16) at full width, 3 steps each at molecule and
           minibatch_lg, every grad_norm finite except egnn's at
           minibatch_lg, where the run is replayed to show each gradient
           finite and the norm finite in float64 (its float32 sum of
           squares overflows); the gnn_neighbor_sampling example; step ms and
           peak memory of each part; where a step goes (batch, adjacency,
           forward, backward, optimizer; one step under torch.profiler:
           the device's busy share and largest kernels) for gin-tu at
           ogb_products and egnn and mace at minibatch_lg;
  sharded  the sharded train step (repro_torch.train.sharded) and its
           aggregation: owner_gather_scatter's local body on each block of a
           4-way contiguous edge partition of gin-tu's ogb_products batch
           (n = 2,449,029, e = 61,859,140) at d = 100 and 64, ell_spmm and
           spmm_residue once each a block, each bit-equal to its plain
           version (the residue in slot order), timed beside its bound, the
           four partial sums within float32's bound of the whole
           aggregation in float64; then, in one NCCL rank of run_ranks on a
           1x1 ("data", "model") mesh, make_sharded_step for gin-tu at
           ogb_products in turns with the unsharded Trainer step (3 steps
           from the same state, losses within 1e-4, step ms, peak GB, the
           kernels' launches a step), and the five reduced LMs and reduced
           dien through make_sharded_step for 2 steps each against the
           unsharded step on the CPU (losses within 1e-4, TF32 off); the
           first's state gathered and saved on the card and restored on
           the CPU bit for bit. No multi-rank time: NCCL takes one GPU a
           rank;
  dien     DIEN at full width: the Trainer at train_batch (65,536 rows in
           8 microbatches, 3 steps), launch.serve's serve_recsys at
           serve_p99 (512) and serve_bulk (262,144) with the serve step
           timed alone (serve_p99's probabilities against the same step
           on the CPU), and the retrieval step at retrieval_cand (1 user
           against 1,000,000 items; its top 100 against float64 scores);
           ms and peak memory of each part, and where a train_batch step
           goes (one microbatch's forward and backward, the profiler);
  lm       the LMs (no port kernel on this path: attention, RoPE, the
           norms, SwiGLU and the MoE dispatch are PyTorch ops, as the
           reference's are XLA ops): phi4-mini-3.8b (8 requests x 2,048
           prompt tokens x 64 new, naive attention) and
           granite-moe-1b-a400m (1 x 32,768 x 16: prefill_32k's length,
           its batch cut from 32 to 1; blockwise attention, two MoE token
           chunks) at full width in bfloat16 through launch.serve's
           serve_lm, twice (the same tokens), from finite logits; the
           prefill's logits against lm_forward's last row, the first
           decode step's against lm_forward over the prompt and that token
           (granite at a 4,096-token prompt), within LM_BF16_TOL; prefill
           ms, decode ms a token, tokens/s, peak memory; then each of the
           five reduced LMs on the card against the CPU from the same
           parameters (prefill, two decode steps, gradients and a train
           step within LM_F32_TOL, TF32 off; float32 KV caches within
           LM_F32_TOL; a float8 cache's bytes equal the CPU's but where a
           value takes the adjacent code (its float32 input differs in the
           last bits), and equal to the card's float32 keys and values
           cast on the CPU), 3 Trainer steps each, a kill-and-resume of
           qwen3-moe-30b-a3b-reduced (exact), to_float8_e4m3fn bit-equal
           to the CPU's, and no port kernel launched;
  figures  the paper's figure scripts (repro_torch.benchmarks) on the
           graph: Table 2's switching trace of the probe root's BFS (each
           direction checked against the switch rule, v_f summing to the
           reach), Table 3's retired fractions at MAX_POS 1-16 (retired +
           residue at 8 within the unvisited count), Table 4's per-layer
           SIMD and non-SIMD bottom-up steps (best of 3 wall times, their
           sums and ratio; both steps' vertices and parents equal on every
           layer), then Fig. 3's harmonic-mean TEPS of hybrid,
           hybrid_nosimd and topdown at edgefactor 16, 32 and 64 (16 roots,
           3 repeats in turns: median and spread), with the launches; the
           edgefactor-32 and -64 graphs at scale 17 at most
           (FIG3_DENSE_SCALE);
  analytics       the analytics layer on LaneEngine(lanes=None) over the
           weighted graph: khop (64 sources, k = 2), bfs_depths, reach_hops,
           closeness (auto: 256 sampled sources), diameter bounds,
           sssp_distances and weighted closeness (32 sources), each with its
           wall time, sweeps, lanes and layers, and the launches of the
           unweighted and the weighted queries; connected_components at
           scale 16 (the cut is printed); depth columns against
           msbfs_pipelined and the serial bfs (one against the numpy
           oracle), closeness of 8 vertices and the diameter bounds against
           the serial bfs, components against scipy, 4 SSSP lanes against
           Dijkstra, weighted closeness against its sources swept again
           (bit-equal) and 2 of their lanes against Dijkstra, every result
           through the wire codec; then
           analytics_bench's closeness and khop points at the graph's
           scale and its components point at scale 16, and sssp_teps'
           wcloseness;
  serve    the serving layer on the weighted graph: an AnalyticsService
           (adaptive lanes, streaming read-outs, sweep recording into a
           flight log, an SLO monitor) replays a 64-request synthetic trace
           (bfs:4,khop:2,reach:1,closeness:1,sssp:1, bursts of 8 every 2
           layers), then serves one khop envelope over its HTTP plane on
           loopback; every answer against run_query on an offline
           LaneEngine, a streamed answer, recorded against unrecorded
           sweeps (64 roots, 32 sources: bit-equal results, traces rebuilt
           from the records), the sweep doctor over the flight log (no
           switch finding), the launches of msbfs_probe, segment_or,
           semiring_relax and relax_fallback in that run; the per-layer
           host ms split into engine step, read-out copy and answer
           assembly, and the recorder's overhead;
  hillclimb       the paper's hillclimb (repro_torch.benchmarks.
           bfs_hillclimb: the B0-B3 mode ladder, O1 without the empty-
           residue skip, the O2 MAX_POS and O3 alpha/beta sweeps, O4's ELL
           top-down) on the graph, 16 roots, 3 repeats in turns: harmonic-
           mean TEPS per point (median and spread), and the O2/O3 points
           whose hybrid beats pure top-down;
  serve_bench     serve_bench's streamed-against-flushed replay of a
           64-request trace of the serve phase's mix at the graph's scale,
           with its own asserts (streamed answers bit-equal to flushed
           ones, a mean khop gain of at least one layer), and its points;
  serve_dist      the sharded service pools on one NCCL rank (run_ranks),
           the weighted graph by file: AnalyticsService(mesh=) over a
           1-rank mesh (the front door, with no followers) replays the
           serve phase's trace with a recorder and the SLO monitor (every
           RequestRecord field and answer wire, by sha256, equal to the
           host replay's; the replay's wall beside the host's; the
           recorders named dist_msbfs and dist_sssp), the ms and host syncs
           of the first ticks of the trace's first burst on the host and
           the sharded service, serve(validate=True) over 32 bfs requests
           (every BFS tree validated), serve_bench on the sharded pools
           (16 queries, its own asserts) and, after the trace's first burst,
           one khop over the HTTP plane against run_query; the launches of
           each part;
  examples        the six graph-side examples (repro_torch.examples)
           through their main on the card, distributed_bfs on one NCCL rank
           (--ndev 1): each one's seconds, launches (the rank's added) and
           returned values, and the kernels each must launch;
  dist_kernel     the kernels of the 1-D distributed engines on the
           card without a process group: bottom_up_probe on every
           bottom-up layer of the probe root's BFS, msbfs_probe and both
           forms of segment_or on the 64-lane sweep layer with the most
           bottom-up lanes, each on every row block of partition_graph(g,
           4) against the global frontier, bit-equal to its plain version,
           with its ms a block beside the whole graph's;
  dist     the sharded engines on one NCCL rank (distributed.ranks.
           run_ranks; NCCL takes one GPU a rank, and the script needs one
           GPU), the graph handed over by file: dist_bfs for Fig. 3's
           16 roots against the serial bfs (parent, depth, layers) with its
           ms a root beside the serial's and the launches of that run
           (bottom_up_probe); run_graph500(batched=True, mesh=) at --roots
           and 4x as many roots in 64 lanes with the launches of each run
           (msbfs_probe, segment_or) and the digest of every result field
           against the host engine's; LaneEngine(mesh=).sweep's depths
           against LaneEngine()'s; the sharded and the host harness at
           --roots, 3 times in turns (from an empty allocator cache),
           and the sweep split into its engine steps and its result (the
           parent derivation), each engine in turns; one sharded sweep
           step by step (wall
           ms, host syncs: 1 a step) and the step's two collectives alone
           (the all-gather of the rank's [n_loc, W] new rows, the counter
           all-reduce with its read-back);
  dist2d_kernel   msbfs_probe and both forms of segment_or on every block
           of a 2x2 grid (partition_graph_2d) at the same sweep layer,
           against the column block's frontier slice x_j assembled from
           the global frontier, bit-equal and timed beside the whole
           graph; bit-equal on every block of the 1x4 and 4x1 grids too;
  dist_sssp_kernel  semiring_relax and relax_fallback on the light and
           the heavy input of an SSSP sweep step with both phases live, on
           every block of a 4-way 1-D and a 2x2 weighted partition (the
           replicated values; the column block's slice), bit-equal and
           timed beside the whole graph;
  dist2d, dist_sssp  one NCCL rank (run_ranks), the weighted graph by
           file: dist2d_msbfs on a 1x1 grid at --roots and 4x as many roots
           in 64 lanes, dense and compressed, with the launches (msbfs_probe,
           segment_or), layers and exchange bytes of each run and every
           result field's digest against the host engine's, xreduction,
           the host engine and both formats timed in rotation, host syncs
           and ms of a step per format (1 and 3 syncs), a khop through
           LaneEngine(grid=(1, 1)); then dist_sssp on a 1-rank mesh and
           dist2d_sssp on the 1x1 grid at default_delta, --sources in 32
           lanes (dense and compressed) and twice as many through them,
           every field bit-equal to sssp_pipelined's, with the launches
           (semiring_relax, relax_fallback), steps and bytes, the host
           engine and both sharded engines in rotation, host syncs and ms
           of a step per engine and format (1 dense; 2 and 3 compressed);
  u64      the port at 64-bit lane words: the same sweeps (run_graph500
           batched=True at --roots and 4x as many roots), a 64-source khop
           and one streamed replay of the serve phase's trace, run here at
           32-bit words and then by this script again in a child process
           with LANE_WORD_BITS=64 (--u64-child; its lines are relayed:
           u64_graph, u64_kernel, u64_ok). The child first holds
           msbfs_probe and both forms of segment_or on random int64 words
           (W = 1, 2, 3, through their int32 view) against their plain
           versions and times them in turns beside the same wrappers on
           the same bits as int32 words, and X1's library call (one
           segment_reduce over the unpacked bits) at each W; its sweeps,
           khop and replay must launch both kernels, and its sweep at
           --roots on the sharded engine over a 1-rank NCCL mesh must
           launch them and give the host sweep's digests, as must a compressed
           sweep on the 2-D engine over a 1x1 grid. sha256 digests of every sweep's parent,
           depth, num_layers, edges_traversed and traces, of the khop
           membership and of every replay answer's result must equal the
           32-bit run's; sweep wall and TEPS, the replay's pool lanes,
           wall, read-out copy ms a packed layer and host split at both
           widths;
  dryrun   the dry-runs, which touch no device (meta tensors over a fake
           process group of 256 or 512 ranks), at once, each in its own
           process: repro_torch.launch.bfs_dryrun at scale 22 and 26 and
           repro_torch.launch.dryrun on an LM cell (phi4-mini-3.8b
           train_4k) and two GNN cells (mace and gin-tu at ogb_products;
           GIN's adjacency a fixed-size CSR, its kernels custom ops on
           meta tensors) on both meshes, which shows this torch has
           fake_pg; each model cell traces the sharded step and must be ok
           with every memory and roofline term; then
           repro_torch.benchmarks.run --only roofline over their records
           (in --out DIR or a temporary directory), which must rank the
           three 16x16 model cells; the records by status
           (none may be an error), each BFS cell's per-layer wire MB by
           direction and its dominant term, each model cell's counted over
           analytic executed FLOPs, its argument, peak, output, temporary,
           HBM and wire GB a device and its roofline, the roofline line,
           seconds;
  kernels  one entry per ported kernel (counts, errors, times, bounds;
           the in-path sums over the layers that ran it, where timed;
           msbfs_probe's and segment_or's u64 record from the child; the
           dist record of bottom_up_probe, msbfs_probe and segment_or; the
           dist2d record of msbfs_probe and segment_or and the dist_sssp
           record of semiring_relax and relax_fallback: launches, block
           and whole-graph ms; the serve_dist launches of the serving
           kernels by part and every kernel's examples launches).
The last line is {"ok": true, "device": {...}}. Any failure raises and
exits nonzero; so does a machine without a GPU or a directory without the
repository's src/, or a u64 child that fails or outlives its time limit
(it is killed then).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import hashlib
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from unittest import mock

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

from repro_torch.analytics import (LaneEngine, bfs_depths,  # noqa: E402
                                   closeness_centrality,
                                   connected_components, diameter_bounds,
                                   khop_neighborhood, reach_hops,
                                   sssp_distances,
                                   weighted_closeness_centrality)
from repro_torch.analytics.api import (AnalyticsAnswer,  # noqa: E402
                                       AnalyticsRequest, KHopQuery,
                                       result_from_wire, result_to_wire,
                                       run_query)
from repro_torch.analytics.closeness import (  # noqa: E402
    closeness_from_dists, select_sources)
from repro_torch.analytics.engine import pad_roots  # noqa: E402
from repro_torch.analytics.khop import KHopResult  # noqa: E402
from repro_torch.benchmarks import (analytics_bench,  # noqa: E402
                                    bfs_hillclimb, serve_bench)
from repro_torch.benchmarks import run as bench_run  # noqa: E402
from repro_torch.benchmarks.fig3_teps import MODES as FIG3_MODES  # noqa: E402
from repro_torch.benchmarks.fig3_teps import teps_point  # noqa: E402
from repro_torch.benchmarks.sssp_teps import (bench_points,  # noqa: E402
                                              unit_weight_graph)
from repro_torch.benchmarks.table2_switching import switching_rows  # noqa: E402
from repro_torch.benchmarks.table3_maxpos import maxpos_rows  # noqa: E402
from repro_torch.benchmarks.table4_counters import (counter_rows,  # noqa: E402
                                                    layer_states as bu_entry)
from repro_torch.core import bitmap  # noqa: E402
from repro_torch.core.bottomup import (_fallback_scan,  # noqa: E402
                                       bottomup_nosimd_step,
                                       bottomup_simd_step)
from repro_torch.configs.base import (effective_cfg, get_arch,  # noqa: E402
                                      make_step, param_builders)
from repro_torch.configs.reduced import reduce_arch  # noqa: E402
from repro_torch.core.csr import CSRGraph, ell_pad, to_numpy_adj  # noqa: E402
from repro_torch.core.dist2d import (  # noqa: E402
    dist2d_msbfs_engine_drain, dist2d_msbfs_engine_enqueue,
    dist2d_msbfs_engine_idle, dist2d_msbfs_engine_init,
    dist2d_msbfs_engine_result, dist2d_msbfs_engine_step, mesh2d,
    partition_graph_2d)
from repro_torch.core.dist_bfs import dist_bfs, partition_graph  # noqa: E402
from repro_torch.core.dist_msbfs import (  # noqa: E402
    dist_msbfs, dist_msbfs_engine_drain, dist_msbfs_engine_enqueue,
    dist_msbfs_engine_idle, dist_msbfs_engine_init, dist_msbfs_engine_result,
    dist_msbfs_engine_step, host_mesh)
from repro_torch.core.dist_sssp import (  # noqa: E402
    default_delta_dist, dist2d_sssp_engine_init,
    dist2d_sssp_engine_result, dist2d_sssp_engine_step,
    dist_sssp_engine_init, dist_sssp_engine_result, dist_sssp_engine_step,
    partition_weighted_graph, partition_weighted_graph_2d)
from repro_torch.core.exchange import all_gather, psum  # noqa: E402
from repro_torch.core.hybrid import (ALPHA_DEFAULT, BETA_DEFAULT,  # noqa: E402
                                     MAX_TRACE, bfs, switch_direction)
from repro_torch.core.msbfs import (_derive_parents, _plan, _refill,  # noqa: E402
                                    msbfs_engine_drain, msbfs_engine_enqueue,
                                    msbfs_engine_idle, msbfs_engine_init,
                                    msbfs_engine_result, msbfs_engine_step,
                                    msbfs_pipelined)
from repro_torch.core.packed import (LANE_WORD_BITS,  # noqa: E402
                                     lane_counters, pack_lanes_np,
                                     unpack_lanes, word_dtype)
from repro_torch.core.ref import bfs_reference  # noqa: E402
from repro_torch.core.topdown import topdown_step  # noqa: E402
from repro_torch.data.pipeline import (gnn_batch, lm_batch,  # noqa: E402
                                       make_batch, recsys_batch)
from repro_torch.distributed.ranks import (load_graph,  # noqa: E402
                                           rank_device, run_ranks,
                                           save_graph)
from repro_torch.graph.generator import (rmat_graph,  # noqa: E402
                                         rmat_weighted_graph, sample_roots)
from repro_torch.graph.graph500 import run_graph500  # noqa: E402
from repro_torch.graph.validate import validate_bfs_tree  # noqa: E402
from repro_torch.kernels import common  # noqa: E402
from repro_torch.kernels.bottom_up_probe.kernel import (  # noqa: E402
    bottom_up_probe_cuda)
from repro_torch.kernels.bottom_up_probe.ref import (  # noqa: E402
    bottom_up_probe_ref, probe_rounds)
from repro_torch.kernels.derive_parents.kernel import (  # noqa: E402
    narrow_depths_cuda, narrow_stride, scan_parents_cuda)
from repro_torch.kernels.derive_parents.ops import derive_parents  # noqa: E402
from repro_torch.kernels.derive_parents.ref import (  # noqa: E402
    derive_parents_ref)
from repro_torch.kernels.ell_spmm.kernel import ell_spmm_cuda  # noqa: E402
from repro_torch.kernels.ell_spmm.ops import (spmm_aggregate,  # noqa: E402
                                              spmm_aggregate_ref)
from repro_torch.kernels.ell_spmm.ref import ell_spmm_ref  # noqa: E402
from repro_torch.kernels.msbfs_probe.kernel import msbfs_probe_cuda  # noqa: E402
from repro_torch.kernels.msbfs_probe.ops import msbfs_probe  # noqa: E402
from repro_torch.kernels.msbfs_probe.ref import (  # noqa: E402
    msbfs_probe_ref, probe_rounds as lane_probe_rounds)
from repro_torch.kernels.relax_fallback.kernel import (  # noqa: E402
    relax_fallback_cuda)
from repro_torch.kernels.relax_fallback.ref import relax_fallback_ref  # noqa: E402
from repro_torch.kernels.segment_or.kernel import (  # noqa: E402
    segment_or_rows_cuda)
from repro_torch.kernels.segment_or.ops import segment_or_rows  # noqa: E402
from repro_torch.kernels.segment_or.ref import segment_or_rows_ref  # noqa: E402
from repro_torch.kernels.semiring_relax.kernel import (  # noqa: E402
    semiring_relax_cuda)
from repro_torch.kernels.semiring_relax.ref import semiring_relax_ref  # noqa: E402
from repro_torch.kernels.spmm_residue.kernel import (  # noqa: E402
    residue_launches, residue_scratch, spmm_residue_cuda)
from repro_torch.kernels.spmm_residue.ref import spmm_residue_ref  # noqa: E402
from repro_torch.kernels.topdown_scan.kernel import topdown_scan_cuda  # noqa: E402
from repro_torch.kernels.topdown_scan.ref import topdown_best_ref  # noqa: E402
from repro_torch.models.gnn import common as gnn_common  # noqa: E402
from repro_torch.models.gnn.common import (ELL_K_MAX,  # noqa: E402
                                           build_adjacency, edge_adjacency)
from repro_torch.distributed.aggregate import (local_aggregate,  # noqa: E402
                                               masked)
from repro_torch.train.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.train.sharded import make_sharded_step  # noqa: E402
from repro_torch.examples import gnn_neighbor_sampling  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models.gnn.gcn import gcn_loss  # noqa: E402
from repro_torch.models.gnn.gin import gin_loss  # noqa: E402
from repro_torch.models.layers import ATTN_CHUNK_THRESHOLD  # noqa: E402
from repro_torch.models.recsys.dien import dien_user_state  # noqa: E402
from repro_torch.models.transformer import (lm_decode_step,  # noqa: E402
                                            lm_forward, lm_prefill,
                                            to_float8_e4m3fn)
from repro_torch.obs import (ObservabilityServer, SLOConfig,  # noqa: E402
                             SweepRecorder, Telemetry, diagnose_log,
                             records_from_jsonl)
from repro_torch.optim.adamw import (adamw_update,  # noqa: E402
                                     clip_by_global_norm, global_norm,
                                     init_opt_state)
from repro_torch.serving import (DONE, AnalyticsService,  # noqa: E402
                                 ServiceConfig, synthetic_trace)
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402
from repro_torch.traversal.ref import to_numpy_weighted  # noqa: E402
from repro_torch.traversal.sssp import (MAX_SSSP_TRACE,  # noqa: E402
                                        default_delta, phase_inputs,
                                        plan_step, prepare_step,
                                        sssp_engine_enqueue, sssp_engine_idle,
                                        sssp_engine_init, sssp_engine_step,
                                        sssp_pipelined)

# H100 SXM peaks (NVIDIA data sheet, at the full 700 W): HBM3 bytes/s, and
# the 32-bit rate outside the tensor cores, used for the integer operations
# of these kernels (the card's int32 rate is not higher, so the bound holds).
MEM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12
MAX_POS = 8
EDGEFACTOR = 16
SEED = 0

KERNELS = {
    "bottom_up_probe": dict(
        route="cuda", source="src/repro_torch/csrc/bottom_up_probe.cu",
        replaces="src/repro/kernels/bottom_up_probe/kernel.py:56"),
    "topdown_scan": dict(
        route="cuda", source="src/repro_torch/csrc/topdown_scan.cu",
        replaces="src/repro/kernels/topdown_scan/kernel.py:39"),
    "msbfs_probe": dict(
        route="cuda", source="src/repro_torch/csrc/msbfs_probe.cu",
        replaces="src/repro/kernels/msbfs_probe/kernel.py:72"),
    "segment_or": dict(
        route="cuda", source="src/repro_torch/csrc/segment_or.cu",
        replaces="src/repro/core/packed.py:113 (segment_or, an XLA "
                 "associative_scan; no Pallas kernel)"),
    "semiring_relax": dict(
        route="cuda", source="src/repro_torch/csrc/semiring_relax.cu",
        replaces="src/repro/kernels/semiring_relax/kernel.py:58"),
    "relax_fallback": dict(
        route="cuda", source="src/repro_torch/csrc/relax_fallback.cu",
        replaces="src/repro/traversal/semiring.py:120 (_relax_fallback + "
                 "tropical segment_reduce, an XLA associative_scan; no "
                 "Pallas kernel)"),
    "ell_spmm": dict(
        route="cuda", source="src/repro_torch/csrc/ell_spmm.cu",
        replaces="src/repro/kernels/ell_spmm/kernel.py:42"),
    "spmm_residue": dict(
        route="cuda", source="src/repro_torch/csrc/spmm_residue.cu",
        replaces="src/repro/kernels/ell_spmm/ops.py:28 (the residue's XLA "
                 "segment_sum; no Pallas kernel)"),
}
SERIAL_KERNELS = ("bottom_up_probe", "topdown_scan")
BATCHED_KERNELS = ("msbfs_probe", "segment_or")
SSSP_KERNELS = ("semiring_relax", "relax_fallback")
GNN_KERNELS = ("ell_spmm", "spmm_residue")
GCN_STEPS = 6  # the Trainer's run: 1 warm-up step and 5 timed
# the gnn_kernel and gcn_layers phases' masked batches: this share of the
# edges masked (seeded), so that the fixed-size CSR holds dead slots
MASKED_SHARE = 0.25
# the gnn_zoo phase: spmm_residue.cu's row pass sums tails of at most this
# many slots in slot order (LONG_TAIL); egnn and mace steps at each shape
RESIDUE_LONG_TAIL = 64
ZOO_SHAPES = ("molecule", "minibatch_lg")
ZOO_STEPS = 3
# (arch, shape) runs whose float32 grad_norm may overflow to inf: EGNN's
# minibatch_lg losses reach 1e26-1e29 at random weights, so the sum of
# squares of its gradients passes float32's range (norm_overflow_witness)
NORM_OVERFLOWS = {("egnn", "minibatch_lg")}
DIEN_STEPS = 3
# the lm phase: (arch, requests, prompt_len, new_tokens, the prompt length
# of the decode-against-forward check) served at full width. granite runs
# prefill_32k's sequence length with its batch cut from 32 to 1 (a 32-way
# batch's cache alone is 51.5 GB); its decode check runs at a 4,096-token
# prompt, since a 32,769-token forward breaks the blockwise attention's
# chunk divisibility
LM_SERVE = (("phi4-mini-3.8b", 8, 2048, 64, 2048),
            ("granite-moe-1b-a400m", 1, 32768, 16, 4096))
LM_ARCHS = ("phi4-mini-3.8b", "qwen1.5-32b", "llama3-405b",
            "granite-moe-1b-a400m", "qwen3-moe-30b-a3b")
LM_STEPS = 3
# bfloat16 full width: serve path against lm_forward, max |a - b| over
# max |b| of the logits (other kernels and sums, rounded to bfloat16's
# 8-bit mantissa at every layer); float32 reduced configs, card against
# the CPU
LM_BF16_TOL = 5e-2
LM_F32_TOL = 1e-4
# an MoE's decode step against the forward in float32 at full width (24
# layers of sums in other orders, no drop)
LM_F32_DECODE_TOL = 1e-3
LANES = 64
SSSP_LANES = 32
SWEEP_TIMED_ROW = 20  # sssp_layers times relax_fallback in full from here
INF = float("inf")
FIG3_EDGEFACTORS = (16, 32, 64)
FIG3_ROOTS = 16
FIG3_REPEATS = 3
# Fig. 3's edgefactor-32 and -64 graphs are built at this scale at most
# (the shared graph, edgefactor 16, keeps --scale): at scale 20 the two
# took about 112-130 s to generate on the host (at 18, 34 s)
FIG3_DENSE_SCALE = 17
KHOP_SOURCES = 64
WEIGHTED_SOURCES = 32
# connected_components seeds 64 roots a sweep and copies the sweep's [n, 64]
# depths to the host: at scale 20, most of whose components are isolated
# vertices, thousands of sweeps (the analytics phase prints the count)
COMPONENTS_SCALE = 16
# closeness against float64 sums of the serial bfs's depths: both sum
# integers below 2**53, so they agree to the last bit; this allows rounding
# in the last place of the final division
CLOSENESS_RTOL = 1e-12
# the serve phase's trace: requests, mix, bursts of SERVE_BURST every
# SERVE_EVERY layers; and its SLO targets (met when nothing is rejected)
SERVE_REQUESTS = 64
SERVE_MIX = "bfs:4,khop:2,reach:1,closeness:1,sssp:1"
SERVE_BURST = 8
SERVE_EVERY = 2
SERVE_SLO = SLOConfig(p99_sojourn_layers=4096, max_queue_depth=1024,
                      max_reject_rate=0.0)
SERVE_KERNELS = BATCHED_KERNELS + SSSP_KERNELS
# weighted closeness: lanes of its sweep held against scipy's Dijkstra
WCLOSENESS_DIJKSTRA_LANES = 2
# the hillclimb's roots and repeats (in turns, as Fig. 3's)
HILLCLIMB_ROOTS = 16
HILLCLIMB_REPEATS = 3
# the u64 phase: 64-bit word widths of the random kernel inputs, and the
# child's time limit
U64_WIDTHS = (1, 2, 3)
U64_CHILD_TIMEOUT = 900
# the dryrun phase: the BFS scales and the model cells it runs, an LM's,
# MACE's and GIN's (its fixed-size adjacency and meta kernels), on both
# meshes (every cell runs on the CPU: python -m
# repro_torch.launch.dryrun --all --both-meshes)
DRYRUN_SCALES = (22, 26)
DRYRUN_CELLS = (("phi4-mini-3.8b", "train_4k"), ("mace", "ogb_products"),
                ("gin-tu", "ogb_products"))
# the sharded phase: GIN's aggregation at ogb_products on each block of a
# 4-way contiguous edge partition (owner_gather_scatter's local body) at the
# layer-0 and the hidden width; the sharded step's steps (gin-tu at
# ogb_products, in turns with the unsharded Trainer) and the reduced
# configs it takes on a 1-rank NCCL mesh, 2 steps each against the CPU
SHARDED_BLOCKS = 4
SHARDED_WIDTHS = (100, 64)
SHARDED_STEPS = 3
SHARDED_ARCHS = ("phi4-mini-3.8b", "qwen1.5-32b", "llama3-405b",
                 "granite-moe-1b-a400m", "qwen3-moe-30b-a3b", "dien")
SHARDED_TOL = 1e-4
DRYRUN_TIMEOUT = 300
# the dist phase: the partition its kernels run on block by block and the
# host/sharded sweep pairs timed in turns
DIST_BLOCKS = 4
DIST_TURNS = 3
DIST_KERNELS = ("bottom_up_probe", "msbfs_probe", "segment_or")
# the dist2d and dist_sssp phases: the grid and the 1-D partition their
# kernels run on block by block (timed), the non-square grids the lane
# kernels are also held on (bit-equal, untimed), and the steps a rank takes
# step by step for its host syncs
GRID = (2, 2)
GRID_CHECKS = ((1, 4), (4, 1))
SYNC_STEPS = 12
# the serve_dist phase's serve_bench queries (the serve_bench phase runs
# SERVE_REQUESTS on the host pools), and its validated bfs requests (each
# tree takes about 4.8 s of a host thread)
SERVE_DIST_BENCH_QUERIES = 16
SERVE_DIST_VALIDATED = 32


class SmokeFailure(RuntimeError):
    pass


def sharded_blocks(dev, reps, flush) -> dict:
    """The sharded phase's kernels: owner_gather_scatter's local body
    (``distributed/aggregate.py::local_aggregate``, a CSR over the block's
    edges into all n rows, through ell_spmm and spmm_residue) on each block
    of a 4-way contiguous edge partition of gin-tu's ogb_products batch, at
    d = 100 (its features) and 64 (a seeded hidden width). Each block's
    kernels must be bit-equal to their plain versions (the residue summed
    in slot order); the blocks' partial sums
    together must lie within float32's summation bound of the whole
    aggregation in float64 (slot order differs between blocks: not bit for
    bit). ell_spmm makes one launch a block, spmm_residue the kernels of
    its column passes and merge (``residue_launches``). Returns the kernels
    line's record, by kernel."""
    arch = get_arch("gin-tu")
    gb = gnn_batch(arch, arch.shape("ogb_products"), 0, seed=SEED + 5,
                   device=dev)
    n, e = gb.n_nodes, gb.n_edges
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    full = build_adjacency(gb)
    deg = full.fwd.deg
    rec = {name: dict(blocks=[], bit_equal=True) for name in GNN_KERNELS}
    sums = []
    for d in SHARDED_WIDTHS:
        x = gb.feats if d == gb.feats.shape[1] else torch.randn(
            (n, d), generator=gen, device=dev)
        total = torch.zeros((n, d), device=dev)
        for b in range(SHARDED_BLOCKS):
            lo, hi = b * e // SHARDED_BLOCKS, (b + 1) * e // SHARDED_BLOCKS
            snd, rcv = gb.senders[lo:hi], gb.receivers[lo:hi]
            mask = gb.edge_mask[lo:hi]
            adj = edge_adjacency(snd, rcv, mask, n)
            g, (neigh, valid) = adj.fwd, adj.fwd_ell
            tail = int((g.deg - ELL_K_MAX).clamp(min=0).max())
            check(tail <= RESIDUE_LONG_TAIL,
                  f"block {b} has a tail of {tail} slots, past the row pass")
            torch.cuda.synchronize()
            common.reset_launches()
            part = local_aggregate(x, snd, rcv, mask, masked, n, adj)
            torch.cuda.synchronize()
            launches = {k: common.LAUNCHES[k] for k in GNN_KERNELS}
            check(launches == {"ell_spmm": 1,
                               "spmm_residue": residue_launches(d)},
                  f"block {b}'s local aggregation launched {launches}")
            slab = ell_spmm_cuda(neigh, valid, x)
            slab_plain = ell_spmm_ref(neigh, valid, x)
            check(torch.equal(slab.view(torch.int32),
                              slab_plain.view(torch.int32)),
                  f"ell_spmm differs from its plain version on block {b}")
            want = residue_slot_order(g, x, slab_plain, ELL_K_MAX)
            check(torch.equal(part.view(torch.int32), want.view(torch.int32)),
                  f"spmm_residue differs from its slot-order plain version "
                  f"on block {b}")
            total += part
            slots = int(valid.sum())
            tail_slots = int((g.deg - ELL_K_MAX).clamp(min=0).sum())
            tail_rows = int((g.deg > ELL_K_MAX).sum())
            costs = {"ell_spmm": slab_cost(n, ELL_K_MAX, slots, n, d),
                     "spmm_residue": residue_cost(n, tail_slots, tail_rows,
                                                  n, d)}
            plain = {"ell_spmm": lambda: ell_spmm_ref(neigh, valid, x),
                     "spmm_residue": lambda: spmm_residue_ref(
                         g.row_ptr, g.src_idx, g.col_idx, x, slab, ELL_K_MAX)}
            acc = slab.clone()     # the residue adds into it in place
            cuda = {"ell_spmm": lambda: ell_spmm_cuda(neigh, valid, x),
                    "spmm_residue": lambda: spmm_residue_cuda(
                        g.row_ptr, g.src_idx, g.col_idx, x, acc,
                        ELL_K_MAX)}
            for name in GNN_KERNELS:
                bms, by = costs[name]
                rec[name]["blocks"].append(dict(
                    block=b, d=d, edges=hi - lo, launches=launches[name],
                    ms=time_ms(cuda[name], reps, flush),
                    plain_ms=time_ms(plain[name], reps, flush),
                    bound_ms=bms, bound_by=by))
            del adj, g, neigh, valid, part, slab, slab_plain, want, acc
        x64 = x.double()
        whole = spmm_aggregate_ref(full.fwd, x64, ELL_K_MAX, full.fwd_ell)
        abs_sum = spmm_aggregate_ref(full.fwd, x64.abs(), ELL_K_MAX,
                                     full.fwd_ell)
        err = (total.double() - whole).abs()
        # each block's rows sum in float32, then the 4 partial sums
        ratio = float((err / f32_bound(abs_sum, deg + SHARDED_BLOCKS)).max())
        check(ratio <= 1.0, f"the blocks' sum at d={d} exceeds float32's "
                            f"bound of the whole aggregation ({ratio})")
        sums.append(dict(d=d, max_abs_err_f64=float(err.max()),
                         bound_ratio=ratio))
        del x, x64, whole, abs_sum, err, total
    for name in GNN_KERNELS:
        rec[name]["block_sums"] = sums
        emit("sharded", part="blocks", name=name, n=n, edges=e,
             n_blocks=SHARDED_BLOCKS, **rec[name])
    return rec


def sharded_rank(ckpt_dir) -> dict:
    """A 1-rank NCCL run: the sharded step (``train/sharded.py``) of gin-tu
    at ogb_products in turns with the unsharded Trainer's, from the same
    state on the same batches; then each reduced config of SHARDED_ARCHS
    through the sharded step against the unsharded step on the CPU, and the
    sharded state of the first gathered and saved for the CPU to restore."""
    from repro_torch.launch.mesh import host_device_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = host_device_mesh(1)
    gin = get_arch("gin-tu")
    shape = gin.shape("ogb_products")
    tr = Trainer(gin, "ogb_products", cfg=TrainerConfig(seed=SEED))
    step = make_sharded_step(gin, shape, mesh)
    params, opt = step.place({k: v.clone() for k, v in tr.params.items()},
                             init_opt_state(tr.params, gin.opt))
    rows = []
    for s in range(SHARDED_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain = tr.run_step()
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        batch = step.shard_batch(gnn_batch(gin, shape, s, seed=SEED,
                                           device=dev))
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        common.reset_launches()
        t0 = time.perf_counter()
        params, opt, got = step(params, opt, batch)
        torch.cuda.synchronize()
        rows.append(dict(
            ms=(time.perf_counter() - t0) * 1e3, plain_ms=plain_ms,
            peak_gb=(torch.cuda.max_memory_allocated() - base) / 1e9,
            launches={k: common.LAUNCHES[k] for k in GNN_KERNELS},
            loss=float(got["loss"]), plain_loss=float(plain["loss"]),
            grad_norm=float(got["grad_norm"]),
            plain_grad_norm=float(plain["grad_norm"])))
        del batch
    out = dict(gin=dict(mode=step.mode, steps=rows))
    del tr, step, params, opt
    torch.cuda.empty_cache()
    reduced = {}
    for arch_id in SHARDED_ARCHS:
        arch = reduce_arch(arch_id)
        shape = next(s for s in arch.shapes if s.kind == "train")
        init = param_builders(arch, shape)[0](
            torch.Generator().manual_seed(SEED))
        cpu_p, cpu_st = init, init_opt_state(init, arch.opt)
        cpu_step = make_step(arch, shape)
        step = make_sharded_step(arch, shape, mesh)
        params, opt = step.place(
            {k: v.to(dev) for k, v in init.items()},
            init_opt_state({k: v.to(dev) for k, v in init.items()},
                           arch.opt))
        losses = []
        common.reset_launches()
        for k in range(2):
            cpu_p, cpu_st, want = cpu_step(cpu_p, cpu_st, make_batch(
                arch, shape, k, seed=SEED, device="cpu"))
            params, opt, got = step(params, opt, step.shard_batch(
                make_batch(arch, shape, k, seed=SEED, device=dev)))
            losses.append((float(got["loss"]), float(want["loss"])))
        reduced[arch.arch_id] = dict(mode=step.mode, losses=losses,
                                     launches=sum(common.LAUNCHES.values()))
        if arch_id == SHARDED_ARCHS[0]:
            whole = step.gather(params, opt)
            CheckpointManager(ckpt_dir).save(2, {"params": whole[0],
                                                 "opt": whole[1]})
            out["saved"] = {k: v.cpu().numpy() for k, v in whole[0].items()}
        del step, params, opt
    out["reduced"] = reduced
    return out


def run_sharded(dev, smi, reps) -> dict:
    """The sharded phase (see the module docstring). Returns the kernels
    line's record, by kernel."""
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=dev)
    rec = sharded_blocks(dev, reps, flush)
    del flush
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_sharded_") as tmp:
        out = run_ranks(sharded_rank, 1, tmp)
        arch = reduce_arch(SHARDED_ARCHS[0])
        tr = Trainer(arch, next(s.shape_id for s in arch.shapes
                                if s.kind == "train"), device="cpu",
                     cfg=TrainerConfig(ckpt_dir=tmp))
        check(tr.maybe_restore() == 2, "the sharded checkpoint did not "
                                       "restore on the CPU")
        restored = all(tr.params[k].numpy().tobytes() == v.tobytes()
                       for k, v in out["saved"].items())
        check(restored, "the CPU's restore differs from the card's state")
    seconds = time.perf_counter() - t0
    steps = out["gin"]["steps"]
    for r in steps:
        check(abs(r["loss"] - r["plain_loss"])
              <= SHARDED_TOL * abs(r["plain_loss"]),
              f"the sharded gin-tu step's loss {r['loss']} against the "
              f"Trainer's {r['plain_loss']}")
        check(all(v > 0 for v in r["launches"].values()),
              f"the sharded gin-tu step launched {r['launches']}")
    for arch_id, r in out["reduced"].items():
        for got, want in r["losses"]:
            check(abs(got - want) <= SHARDED_TOL * abs(want),
                  f"{arch_id}'s sharded loss {got} on the card against "
                  f"{want} on the CPU")
    ms = [r["ms"] for r in steps]
    emit("sharded", part="gin_step", card=smi, arch="gin-tu",
         shape="ogb_products", ranks=1, mode=out["gin"]["mode"],
         steps=steps, step_ms=spread(ms[1:]),
         plain_step_ms=spread([r["plain_ms"] for r in steps][1:]),
         peak_gb=max(r["peak_gb"] for r in steps))
    emit("sharded", part="reduced", card=smi, ranks=1, **out["reduced"],
         checkpoint_restored_on_cpu=restored, rank_seconds=seconds)
    for name in GNN_KERNELS:
        rec[name]["step_launches"] = [r["launches"][name] for r in steps]
    return rec


def run_dryrun(args, smi) -> None:
    """The dryrun phase (see the module docstring)."""
    t0 = time.perf_counter()
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
    env = dict(os.environ, PYTHONPATH=src)
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.abspath(args.out or tmp)
        out = os.path.join(root, "artifacts", "dryrun_torch")
        runs = [["repro_torch.launch.bfs_dryrun", "--scale", str(s)]
                for s in DRYRUN_SCALES]
        runs += [["repro_torch.launch.dryrun", "--arch", arch_id,
                  "--shape", shape_id, "--both-meshes"]
                 for arch_id, shape_id in DRYRUN_CELLS]
        # the dry-runs at once, each in a process of its own (each starts
        # a fake process group, which this process must not hold)
        procs = [subprocess.Popen(
            [sys.executable, "-m", *cmd, "--out", out], env=env, cwd=root,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for cmd in runs]
        seconds = {}
        try:
            for cmd, p in zip(runs, procs):
                stdout, stderr = p.communicate(timeout=DRYRUN_TIMEOUT)
                seconds[" ".join(cmd[:3])] = time.perf_counter() - t0
                if p.returncode != 0:
                    sys.stderr.write(stdout[-4000:] + stderr[-8000:])
                check(p.returncode == 0, f"{cmd[0]} exited {p.returncode}")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        # the roofline bench over their records, in this process: it only
        # reads the records under its working directory
        buf, cwd = io.StringIO(), os.getcwd()
        os.chdir(root)
        try:
            with contextlib.redirect_stdout(buf):
                bench_run.main(["--only", "roofline"])
        finally:
            os.chdir(cwd)
        roofline = buf.getvalue().strip().splitlines()[-1]
        recs = [json.loads(open(os.path.join(out, f)).read())
                for f in sorted(os.listdir(out))]
    status = {}
    for r in recs:
        status[r["status"]] = status.get(r["status"], 0) + 1
    bfs_recs = [r for r in recs if r.get("kind") == "dist_bfs"]
    cells = [r for r in recs if "arch" in r]
    check("error" not in status, "a dry-run cell is an error")
    check(len(bfs_recs) == 2 * len(DRYRUN_SCALES)
          and all(r["status"] == "ok" for r in bfs_recs),
          "the BFS dry-run records are not all ok")
    check(len(cells) == 2 * len(DRYRUN_CELLS)
          and all(r["status"] == "ok" and r["counted_flops_global"]
                  and None not in r["roofline"].values()
                  and None not in r["memory"].values() for r in cells),
          f"{len(cells)} model cell records, not {2 * len(DRYRUN_CELLS)} "
          f"ok with every term")
    # the model cells have all three terms and a compute term (a BFS layer
    # counts no FLOPs): one a cell on the 16x16 mesh
    check(roofline.startswith("roofline,")
          and f",cells={len(DRYRUN_CELLS)};" in roofline,
          f"the roofline bench printed {roofline!r}")
    emit("dryrun", card=smi, status=status, roofline=roofline,
         bfs=[dict(scale=r["scale"], mesh=r["mesh"],
                   wire_mb_per_layer={
                       d: v / 1e6 for d, v in r["collective"][
                           "per_layer_wire_bytes_by_direction"].items()},
                   dominant=r["roofline"]["dominant"],
                   peak_live_gb=r["memory"]["peak_live_bytes"] / 1e9)
              for r in bfs_recs],
         counted_over_executed={
             f"{r['arch']}/{r['shape']}/{r['mesh']}":
             r["counted_flops_global"] / r["executed_flops_global"]
             for r in cells},
         cells={f"{r['arch']}/{r['shape']}/{r['mesh']}": dict(
             argument_gb=r["memory"]["argument_bytes"] / 1e9,
             peak_gb=r["memory"]["peak_bytes"] / 1e9,
             output_gb=r["memory"]["output_bytes"] / 1e9,
             temp_gb=r["memory"]["temp_bytes"] / 1e9,
             hbm_gb=r["hbm_bytes_per_device"] / 1e9,
             wire_gb=r["collective"]["wire_bytes_per_device"] / 1e9,
             collectives=r["collective"]["num_collectives"],
             roofline=r["roofline"], sharded=r["sharded"])
             for r in cells},
         command_seconds=seconds, seconds=time.perf_counter() - t0)


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def time_ms(fn, reps: int, flush: torch.Tensor) -> float:
    """Median device time of ``fn`` in ms (CUDA events), after a warm-up.
    ``flush`` (larger than L2) is overwritten before each run, so the run
    starts with a cold L2 and the device is busy while the host launches."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def wall_ms(fn, reps: int) -> float:
    """Median host wall time of ``fn`` followed by a device sync, in ms."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / MEM_BYTES_PER_S * 1e3
    t_ops = ops / OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def probe_cost(n, n_unvisited, probes, hits, nw):
    # what the work needs, whatever implements it: reads the unvisited
    # flags (a byte each), the parents that pass through (all but the
    # hits'), the unvisited rows' bounds (row_ptr, at most all of it), one
    # neighbour id per probe and the frontier words those probes test (at
    # most the bitmap); writes found + parent
    nbytes = (n + 4 * (n - hits) + min(4 * (n + 1), 8 * n_unvisited)
              + 4 * probes + 4 * min(nw, probes) + 8 * n)
    ops = 4 * n + 8 * probes
    return bound_ms(nbytes, ops)


def probe_work(g, unv, parent, fw):
    """B1's plain version on the kernel's inputs, and the work it needs:
    (plain args, plain result, probes, hits). A probe is a neighbour
    gather: every live round up to and including the hit."""
    args = (g.row_ptr[:-1], g.deg, unv.to(torch.int32), parent, g.col_idx,
            fw, MAX_POS)
    probes = sum(int(live.sum()) for live, _, _ in probe_rounds(
        *args[:3], g.col_idx, fw, MAX_POS))
    want = bottom_up_probe_ref(*args)
    return args, want, probes, int(want[0].sum())


def scan_cost(n, active_edges, frontier_rows, nw):
    # what the work needs, whatever implements it: reads both bitmaps, the
    # frontier rows' bounds and their col_idx slots; writes best
    nbytes = 8 * nw + 8 * frontier_rows + 4 * active_edges + 4 * n
    ops = n + 6 * active_edges
    return bound_ms(nbytes, ops)


def scan_library(g, f, v):
    """The top-down scan's library yardstick on frontier ``f`` and visited
    ``v``: one scatter_reduce(amin) into an all-n best over the candidates
    of the frontier rows' slots with an unvisited destination, built
    outside the timing."""
    n = g.n
    live = f[g.src_idx.long()] & ~v[g.col_idx.long()]
    index = g.col_idx[live].long()
    cand = g.src_idx[live]
    init = torch.full((n,), n, dtype=torch.int32, device=g.device)
    return lambda: torch.scatter_reduce(init, 0, index, cand, "amin")


def max_abs_err(pairs) -> int:
    return max(int((a.long() - b.long()).abs().max()) if a.numel() else 0
               for a, b in pairs)


def layer_states(g, out):
    """(frontier, visited, parent) at the start of every layer of ``out``."""
    depth, parent = out.depth, out.parent
    for layer in range(int(out.num_layers)):
        visited = (depth >= 0) & (depth <= layer)
        yield (layer, depth == layer, visited,
               torch.where(visited, parent, -1))


def compare_kernels(g, out, dev, reps, flush):
    """Each kernel against its plain version: a seeded random split, then
    every layer state of ``out``. Returns the per-kernel record."""
    n, m = g.n, g.m
    deg = g.deg
    rng = np.random.default_rng(SEED)
    vis = torch.from_numpy(rng.random(n) < 0.4).to(dev)
    fro = torch.from_numpy(rng.random(n) < 0.25).to(dev) & ~vis
    par0 = torch.full((n,), -1, dtype=torch.int32, device=dev)
    cases = [("random", fro, vis, par0)] + [
        (f"layer{layer}", f, v, p) for layer, f, v, p in layer_states(g, out)]
    rec = {name: dict(cases=0, max_abs_err=0) for name in SERIAL_KERNELS}
    for label, f, v, p in cases:
        fw, vw = bitmap.pack(f), bitmap.pack(v)
        unv = ~v
        # the kernels read row_ptr (and the probe the bool flags); the
        # plain probe takes starts, degrees and int32 flags, the plain scan
        # every slot by src_idx
        probe_args = (g.row_ptr, unv, p, g.col_idx, fw, MAX_POS)
        plain_probe_args, r_probe, probes, hits = probe_work(g, unv, p, fw)
        scan_args = (g.row_ptr, g.col_idx, fw, vw, n)
        plain_scan_args = (g.src_idx, g.col_idx, fw, vw, n)
        k_probe = bottom_up_probe_cuda(*probe_args)
        k_scan = topdown_scan_cuda(*scan_args)
        r_scan = topdown_best_ref(*plain_scan_args)
        torch.cuda.synchronize()
        for name, k, r in (("bottom_up_probe", k_probe, r_probe),
                           ("topdown_scan", (k_scan,), (r_scan,))):
            err = max_abs_err(zip(k, r))
            check(err == 0 and all(torch.equal(a, b) for a, b in zip(k, r)),
                  f"{name} differs from its plain version on {label}")
            rec[name]["cases"] += 1
            rec[name]["max_abs_err"] = max(rec[name]["max_abs_err"], err)
        if label.startswith("layer"):
            nxt = (out.depth == int(label[5:]) + 1)
            check(torch.equal((k_scan < n) & ~v, nxt),
                  f"topdown_scan on {label} does not give the next layer")
        if label != "random":
            continue
        nw = fw.numel()
        active = int(torch.where(f, deg, 0).sum())
        rows = int(f.sum())
        for name, args, plain_args, fn, plain, cost in (
                ("bottom_up_probe", probe_args, plain_probe_args,
                 bottom_up_probe_cuda, bottom_up_probe_ref,
                 probe_cost(n, int(unv.sum()), probes, hits, nw)),
                ("topdown_scan", scan_args, plain_scan_args,
                 topdown_scan_cuda, topdown_best_ref,
                 scan_cost(n, active, rows, nw))):
            rec[name].update(
                ms=time_ms(lambda: fn(*args), reps, flush),
                plain_ms=time_ms(lambda: plain(*plain_args), reps, flush),
                bound_ms=cost[0], bound_by=cost[1])
        library = scan_library(g, f, v)
        check(torch.equal(library(), k_scan),
              "the top-down scan's library yardstick computes another "
              "function")
        rec["topdown_scan"]["library_ms"] = time_ms(library, reps, flush)
        del library
        rec["bottom_up_probe"]["timed_input"] = dict(
            case="random", unvisited=int(unv.sum()), probes=probes,
            hits=hits)
        rec["topdown_scan"]["timed_input"] = dict(
            case="random", active_edges=active, frontier_rows=rows,
            slots_of_graph=m)
    for name, r in rec.items():
        emit("kernel", name=name, bit_equal=True, **r)
    return rec


def layer_breakdown(g, root, out, reps, flush, rec):
    """Time one hybrid BFS layer by layer: the counters' host sync, the
    step the controller chose, and inside it the kernel (with its bound)
    and the fallback. Each kernel's layer times and bounds also go to its
    record in ``rec`` (``layers``)."""
    n, deg = g.n, g.deg
    dirs = out.trace_dir.tolist()
    rows = []
    for layer, f, v, p in layer_states(g, out):
        td = dirs[layer] == 0

        def counters():
            torch.stack([f.sum(), torch.where(f, deg, 0).sum(),
                         torch.where(v, 0, deg).sum()]).tolist()

        fw = bitmap.pack(f)
        row = dict(layer=layer, dir="TD" if td else "BU",
                   v_f=int(out.trace_vf[layer]),
                   counters_ms=wall_ms(counters, reps))
        if td:
            vw = bitmap.pack(v)
            row["step_ms"] = wall_ms(lambda: topdown_step(g, f, v, p), reps)
            row["kernel_ms"] = time_ms(
                lambda: topdown_scan_cuda(g.row_ptr, g.col_idx, fw, vw, n),
                reps, flush)
            row["active_edges"] = int(torch.where(f, deg, 0).sum())
            row["bound_ms"] = scan_cost(n, row["active_edges"], row["v_f"],
                                        fw.numel())[0]
        else:
            unv = ~v
            row["step_ms"] = wall_ms(
                lambda: bottomup_simd_step(g, f, v, p, MAX_POS), reps)
            row["kernel_ms"] = time_ms(
                lambda: bottom_up_probe_cuda(g.row_ptr, unv, p, g.col_idx, fw,
                                             MAX_POS),
                reps, flush)
            _, (found, _), probes, hits = probe_work(g, unv, p, fw)
            row["unvisited"] = int(unv.sum())
            row["probes"] = probes
            row["bound_ms"] = probe_cost(n, row["unvisited"], probes, hits,
                                         fw.numel())[0]
            rem = unv & (found == 0) & (deg > MAX_POS)
            row["residue"] = int(rem.sum())
            # the step skips the fallback when no vertex is left for it
            row["fallback_ms"] = wall_ms(
                lambda: _fallback_scan(g, fw, rem, p, MAX_POS),
                reps) if row["residue"] else 0.0
        rows.append(row)
    totals = {}
    for name, way in (("topdown_scan", "TD"), ("bottom_up_probe", "BU")):
        done = [r for r in rows if r["dir"] == way]
        rec[name]["layers"] = layer_sums(done, "kernel_ms", "bound_ms",
                                         root=root)
        totals[way] = rec[name]["layers"]
    emit("layers", root=root, rows=rows,
         step_ms_total=sum(r["step_ms"] + r["counters_ms"] for r in rows),
         topdown_kernel_ms_total=totals["TD"]["ms_total"],
         topdown_bound_ms_total=totals["TD"]["bound_ms_total"],
         bottomup_kernel_ms_total=totals["BU"]["ms_total"],
         bottomup_bound_ms_total=totals["BU"]["bound_ms_total"])


def layer_sums(rows, ms_key, bound_key, **extra):
    """A kernel's in-path record over the layer rows that ran it: each
    layer's time and bound, and their sums."""
    return dict(**extra, layers=[r["layer"] for r in rows],
                ms=[r[ms_key] for r in rows],
                bound_ms=[r[bound_key] for r in rows],
                ms_total=sum(r[ms_key] for r in rows),
                bound_ms_total=sum(r[bound_key] for r in rows))


def run_main_path(g, args):
    """The serial Graph500 harness through the port's entry point, then
    its checks. Returns (result, launches of the harness run)."""
    common.reset_launches()
    t0 = time.perf_counter()
    res = run_graph500(args.scale, EDGEFACTOR, mode="hybrid",
                       num_roots=args.roots, seed=SEED, graph=g)
    seconds = time.perf_counter() - t0
    launches = dict(common.LAUNCHES)
    for name in SERIAL_KERNELS:
        check(launches[name] > 0, f"{name} was not launched on the main path")

    rp, ci = to_numpy_adj(g)
    roots = res.roots
    validated = []
    for r in roots[:8]:
        out = bfs(g, r, "hybrid")
        validate_bfs_tree(rp, ci, out.parent.cpu().numpy(), r)
        validated.append(r)
    r0 = roots[0]
    out0 = bfs(g, r0, "hybrid")
    pref, dref = bfs_reference(rp, ci, r0)
    check(np.array_equal(out0.parent.cpu().numpy(), pref),
          "hybrid parent differs from bfs_reference")
    check(np.array_equal(out0.depth.cpu().numpy(), dref),
          "hybrid depth differs from bfs_reference")
    for r in roots[:2]:
        ph = bfs(g, r, "hybrid").parent
        for mode in ("topdown", "bottomup_simd"):
            check(torch.equal(bfs(g, r, mode).parent, ph),
                  f"{mode} parent differs from hybrid for root {r}")
    n_layers = int(out0.num_layers)
    times_ms = np.asarray(res.times) * 1e3
    emit("main", entry="repro_torch.graph.graph500.run_graph500",
         seconds=seconds, launches=launches,
         validated_roots=validated, oracle_root=r0, cross_mode_roots=roots[:2],
         layers=n_layers, peak_mem_bytes=torch.cuda.max_memory_allocated(),
         trace_dir=out0.trace_dir[:n_layers].tolist(),
         time_ms_median=float(np.median(times_ms)),
         time_ms_p84=float(np.percentile(times_ms, 84)), **res.summary())
    check(all(t > 0 for t in res.teps), "a root traversed no edges")
    check(n_layers < MAX_TRACE, "BFS did not finish within the trace buffer")
    return res, launches


def lane_probe_cost(n, w, rows, probes, words):
    # what the work needs, whatever implements it: reads the need words,
    # the bounds of the rows with a needed lane (row_ptr, at most all of
    # it), one neighbour id per round in which any plane gathers, each
    # gathered frontier word (at most the whole frontier); writes acc
    nbytes = (8 * n * w + min(4 * (n + 1), 8 * rows) + 4 * probes
              + 4 * min(words, n * w))
    ops = 4 * n * w + 3 * words
    return bound_ms(nbytes, ops)


def lane_probe_work(pa):
    """The work B3's plain version on args ``pa`` needs: (rows with a
    needed lane, rounds in which any plane gathers, plane gathers)."""
    probes = words = 0
    for live, _ in lane_probe_rounds(*pa):
        probes += int(live.any(dim=-1).sum())
        words += int(live.sum())
    rows = int((pa[2] != 0).any(dim=-1).sum())
    return rows, probes, words


def row_or_cost(n, w, edges, has_base, has_active, nf):
    # reads: row_ptr, the row flags, each edge slot's neighbour id once,
    # each row's frontier words once (at most the whole frontier), mask and
    # base; writes: out
    nbytes = (4 * (n + 1) + (4 * n if has_active else 0) + 4 * edges
              + 4 * min(edges, nf) * w + 4 * n * w * (3 if has_base else 2))
    ops = 2 * edges * w + 2 * n * w
    return bound_ms(nbytes, ops)


def random_lanes(n, w, seed, dev):
    """Seeded random lane words: visited at a quarter of the bits, the
    frontier at about a fifth outside it."""
    rng = np.random.default_rng(seed)

    def words():
        return torch.from_numpy(rng.integers(0, 2 ** 32, (n, w),
                                             dtype=np.uint32).view(np.int32))
    vis = (words() & words()).to(dev)
    fro = (words() & words()).to(dev) & ~vis
    return fro, vis


class LaneKernelCheck:
    """msbfs_probe and segment_or against their plain versions; keeps the
    cases, the largest difference, and the timed input's record."""

    def __init__(self, g):
        self.g = g
        self.rec = {name: dict(cases=0, max_abs_err=0)
                    for name in BATCHED_KERNELS}
        self.deg = g.deg

    def _agree(self, name, label, k, r):
        err = max_abs_err([(k, r)])
        check(err == 0 and torch.equal(k, r),
              f"{name} differs from its plain version on {label}")
        self.rec[name]["cases"] += 1
        self.rec[name]["max_abs_err"] = max(self.rec[name]["max_abs_err"],
                                            err)

    def probe_args(self, frontier, need):
        """The kernel's arguments (row_ptr) and the plain version's
        (starts and degrees)."""
        g = self.g
        return ((g.row_ptr, need, g.col_idx, frontier, MAX_POS),
                (g.row_ptr[:-1], self.deg, need, g.col_idx, frontier,
                 MAX_POS))

    def fallback_args(self, frontier, need, acc):
        g = self.g
        found = acc & need
        residue = (((need & ~found) != 0).any(dim=-1)
                   & (self.deg > MAX_POS)).to(torch.int32)
        return (g.row_ptr, g.col_idx, frontier, need, None, found, residue,
                MAX_POS)

    def topdown_args(self, frontier, visited, td_sel):
        g = self.g
        return (g.row_ptr, g.col_idx, frontier, ~visited, td_sel, None, None,
                0)

    def bottomup(self, label, frontier, need):
        """Probe, then the fallback form of the row-OR; returns the args
        (the probe's as the kernel and the plain version take them)."""
        ka, pa = self.probe_args(frontier, need)
        acc = msbfs_probe_cuda(*ka)
        self._agree("msbfs_probe", label, acc, msbfs_probe_ref(*pa))
        fa = self.fallback_args(frontier, need, acc)
        self._agree("segment_or", f"{label} (bottom-up fallback)",
                    segment_or_rows_cuda(*fa), segment_or_rows_ref(*fa))
        return ka, pa, fa

    def topdown(self, label, frontier, visited, td_sel):
        ta = self.topdown_args(frontier, visited, td_sel)
        self._agree("segment_or", f"{label} (top-down)",
                    segment_or_rows_cuda(*ta), segment_or_rows_ref(*ta))
        return ta


def lane_kernel_random(chk, dev, reps, flush):
    """Both kernels on seeded random lane words at W = 2 (timed), 8 and
    16 (the row-OR in two 8-word chunks)."""
    g = chk.g
    n, m = g.n, g.m
    for w in (LANES // 32, 8, 16):
        fro, vis = random_lanes(n, w, SEED + w, dev)
        need = ~vis
        all_lanes = torch.full((w,), -1, dtype=torch.int32, device=dev)
        ka, pa, fa = chk.bottomup(f"random W={w}", fro, need)
        ta = chk.topdown(f"random W={w}", fro, vis, all_lanes)
        torch.cuda.synchronize()
        if w != LANES // 32:
            continue
        rows, probes, words = lane_probe_work(pa)
        cost = lane_probe_cost(n, w, rows, probes, words)
        chk.rec["msbfs_probe"].update(
            ms=time_ms(lambda: msbfs_probe_cuda(*ka), reps, flush),
            plain_ms=time_ms(lambda: msbfs_probe_ref(*pa), reps, flush),
            bound_ms=cost[0], bound_by=cost[1], library_ms=None,
            timed_input=dict(case=f"random W={w}", vertices=n,
                             rows_with_need=rows, probes=probes,
                             plane_gathers=words))
        # the top-down form reads every edge slot; its library yardstick is
        # one segment_reduce over the edge contributions unpacked to bits,
        # prepared outside the timing
        bits = unpack_lanes(fro[g.col_idx], 32 * w).to(torch.float32)
        lengths = g.deg.to(torch.int64)

        def library():
            return torch.segment_reduce(bits, "max", lengths=lengths,
                                        axis=0, unsafe=True, initial=0.0)

        lib = library()
        check(torch.equal(lib.to(torch.bool), unpack_lanes(
            segment_or_rows_cuda(*ta[:3], torch.full_like(vis, -1),
                                 *ta[4:]), 32 * w)),
              "the library yardstick computes another function")
        cost = row_or_cost(n, w, m, False, False, n)
        chk.rec["segment_or"].update(
            ms=time_ms(lambda: segment_or_rows_cuda(*ta), reps, flush),
            plain_ms=time_ms(lambda: segment_or_rows_ref(*ta), reps, flush),
            library_ms=time_ms(library, reps, flush),
            bound_ms=cost[0], bound_by=cost[1],
            timed_input=dict(case=f"random W={w} (top-down form)",
                             rows=n, edge_slots=m))
        del bits, lib


def syncs_of(fn) -> int:
    """Host syncs ``fn`` makes, as torch's sync debug mode reports them."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # not the one-off note that the debug mode is a prototype
    return sum("called a synchronizing" in str(c.message) for c in caught)


def batched_sweep(g, roots, chk, reps, flush):
    """One sweep of the pipelined engine, one lane per root, stepped layer
    by layer. Each layer state goes through both kernels against their
    plain versions, and is timed: the counters' read-back, the step, the
    kernels. Returns the per-layer rows and the drained state."""
    n = g.n
    s = msbfs_engine_enqueue(msbfs_engine_init(g, len(roots), LANES), roots)
    rows = []
    while not msbfs_engine_idle(s):
        s = _refill(g, s, True)  # seats the roots on the first layer
        topdown, live = _plan(s, "hybrid", n, ALPHA_DEFAULT, BETA_DEFAULT)
        td, bu = topdown & live, ~topdown & live
        td_sel = torch.from_numpy(pack_lanes_np(td)).to(g.device)
        bu_sel = torch.from_numpy(pack_lanes_np(bu)).to(g.device)
        f, v = s.frontier, s.visited
        label = f"sweep layer {s.sweep_layers}"
        row = dict(layer=s.sweep_layers,
                   active=int((s.lane_qidx < s.capacity).sum()),
                   td_lanes=int(td.sum()), bu_lanes=int(bu.sum()),
                   v_f=int(s.counters[1].sum()))

        def counters():
            torch.stack(lane_counters(g, unpack_lanes(f, LANES),
                                      unpack_lanes(v, LANES))).cpu()

        row["counters_ms"] = wall_ms(counters, reps)
        row["syncs"] = syncs_of(lambda: msbfs_engine_step(g, s))
        row["step_ms"] = wall_ms(lambda: msbfs_engine_step(g, s), reps)
        kernel_ms = 0.0
        w = LANES // 32
        if bu.any():
            ka, pa, fa = chk.bottomup(label, f, ~v & bu_sel)
            row["fallback_rows"] = int(fa[6].sum())
            row["fallback_slots"] = int(torch.where(
                fa[6] != 0, (g.deg - MAX_POS).clamp(min=0), 0).sum())
            row["probe_ms"] = time_ms(lambda: msbfs_probe_cuda(*ka), reps,
                                      flush)
            row["probe_bound_ms"] = lane_probe_cost(
                n, w, *lane_probe_work(pa))[0]
            row["fallback_ms"] = time_ms(lambda: segment_or_rows_cuda(*fa),
                                         reps, flush)
            row["fallback_bound_ms"] = row_or_cost(
                n, w, row["fallback_slots"], True, True, n)[0]
            kernel_ms += row["probe_ms"] + row["fallback_ms"]
        if td.any():
            ta = chk.topdown(label, f, v, td_sel)
            row["topdown_ms"] = time_ms(lambda: segment_or_rows_cuda(*ta),
                                        reps, flush)
            row["topdown_bound_ms"] = row_or_cost(n, w, g.m, False, False,
                                                  n)[0]
            kernel_ms += row["topdown_ms"]
        row["kernel_ms"] = kernel_ms
        rows.append(row)
        s = msbfs_engine_step(g, s)
    return rows, s


def batched_layers(g, roots, chk, reps, flush):
    rows, s = batched_sweep(g, roots, chk, reps, flush)
    # segment_or's two forms over the sweep, each against its own bound
    forms = {}
    for form in ("topdown", "fallback"):
        done = [r for r in rows if f"{form}_ms" in r]
        forms[form] = dict(
            layers=len(done), ms_total=sum(r[f"{form}_ms"] for r in done),
            bound_ms_total=sum(r[f"{form}_bound_ms"] for r in done))
    chk.rec["segment_or"]["forms"] = forms
    chk.rec["msbfs_probe"]["layers"] = layer_sums(
        [r for r in rows if "probe_ms" in r], "probe_ms", "probe_bound_ms")
    depth = msbfs_engine_result(g, s, derive_parents=False).depth
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _derive_parents(g, depth, roots)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    derive_ms = wall_ms(lambda: _derive_parents(g, depth, roots),
                        max(reps // 2, 2))
    emit("batched_layers", roots=len(roots), lanes=LANES, rows=rows,
         layers=len(rows),
         step_ms_total=sum(r["step_ms"] for r in rows),
         kernel_ms_total=sum(r["kernel_ms"] for r in rows),
         syncs_per_layer=[r["syncs"] for r in rows], segment_or_forms=forms,
         msbfs_probe_layers=chk.rec["msbfs_probe"]["layers"],
         derive_parents_ms=derive_ms, derive_parents_peak_bytes=peak)
    return len(rows)


def parents_cost(g, depth) -> tuple[float, float, dict]:
    """X5's bounds in ms: the depths and the CSR read once and the parents
    written once; and that plus one narrowed row per edge slot of a row
    with a lane to find (a row with none reads no neighbour), as if none of
    those reads hit L2."""
    n, r = depth.shape
    live = (depth >= 1).any(dim=1)
    slots = int(torch.where(live, g.deg, 0).sum())
    parts = dict(depth=4 * n * r, csr=4 * (g.n + 1 + g.m), parent=4 * n * r)
    once = sum(parts.values())
    parts.update(narrowed_rows=narrow_stride(r) * slots, slots=slots)
    return (bound_ms(once, 0)[0],
            bound_ms(once + parts["narrowed_rows"], 0)[0], parts)


def run_parents_kernel(g, roots, reps, flush):
    """X5 at the parents cell's shape: the depths of one drained sweep of
    ``roots`` in as many lanes, the kernel against its plain version (bit
    for bit), both timed, beside the bound."""
    depth = msbfs_pipelined(g, roots, "hybrid", lanes=len(roots),
                            derive_parents=False).depth
    args = (g.row_ptr, g.col_idx, g.src_idx, depth)
    before = common.LAUNCHES["derive_parents"]
    got = derive_parents(*args)
    torch.cuda.synchronize()
    launches = common.LAUNCHES["derive_parents"] - before
    want = derive_parents_ref(*args)
    check(torch.equal(got, want), "derive_parents differs from its plain "
                                  "version")
    del want
    narrow = narrow_depths_cuda(depth)
    bound, bound_rows, parts = parents_cost(g, depth)
    kernel_ms = time_ms(lambda: derive_parents(*args), reps, flush)
    plain_ms = time_ms(lambda: derive_parents_ref(*args),
                       max(reps // 4, 3), flush)
    emit("parents_kernel", roots=len(roots), n=g.n, m=g.m, bit_equal=True,
         launches_per_call=launches, ms=kernel_ms,
         narrow_ms=time_ms(lambda: narrow_depths_cuda(depth), reps, flush),
         scan_ms=time_ms(lambda: scan_parents_cuda(
             g.row_ptr, g.col_idx, narrow, depth.shape[1]), reps, flush),
         bound_ms=bound, bound_by="bytes", bound_rows_ms=bound_rows,
         bound_bytes=parts,
         roofline_pct=100 * bound / kernel_ms, plain_ms=plain_ms,
         library_ms=plain_ms,
         peak_bytes=peak_of(lambda: derive_parents(*args))[2],
         plain_peak_bytes=peak_of(lambda: derive_parents_ref(*args))[2],
         reached=int((depth >= 0).sum()))


def run_batched_path(g, args, serial_res):
    """The batched Graph500 harness through the port's entry point, then
    its checks. Returns the launches of the harness run."""
    roots = sample_roots(g, args.roots, seed=SEED + 1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    common.reset_launches()
    t0 = time.perf_counter()
    res = run_graph500(args.scale, EDGEFACTOR, mode="hybrid",
                       num_roots=args.roots, seed=SEED, graph=g,
                       batched=True, lanes=LANES)
    seconds = time.perf_counter() - t0
    launches = dict(common.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    for name in BATCHED_KERNELS:
        check(launches[name] > 0,
              f"{name} was not launched on the batched path")
    check(res.roots == [int(r) for r in roots], "harness sampled other roots")

    out = msbfs_pipelined(g, roots, "hybrid", lanes=LANES)
    for r_i, r in enumerate(roots):
        want = bfs(g, int(r), "hybrid")
        check(torch.equal(out.depth[:, r_i], want.depth),
              f"lane {r_i} depth differs from serial bfs")
        check(torch.equal(out.parent[:, r_i], want.parent),
              f"lane {r_i} parent differs from serial bfs")
        if r_i < 4:
            for name in ("num_layers", "edges_traversed"):
                check(int(getattr(out, name)[r_i])
                      == int(getattr(want, name)),
                      f"lane {r_i} {name} differs from serial bfs")
            for name in ("trace_dir", "trace_vf", "trace_ef", "trace_eu"):
                check(torch.equal(getattr(out, name)[:, r_i],
                                  getattr(want, name)),
                      f"lane {r_i} {name} differs from serial bfs")
    rp, ci = to_numpy_adj(g)
    parent = out.parent.cpu().numpy()
    for r_i, r in enumerate(roots[:8]):
        validate_bfs_tree(rp, ci, parent[:, r_i], int(r))
    pref, dref = bfs_reference(rp, ci, int(roots[0]))
    check(np.array_equal(parent[:, 0], pref)
          and np.array_equal(out.depth[:, 0].cpu().numpy(), dref),
          "lane 0 differs from bfs_reference")
    del out, parent

    # 4x the roots through the same lanes: lanes refill from the queue
    many = 4 * args.roots
    torch.cuda.reset_peak_memory_stats()
    res4 = run_graph500(args.scale, EDGEFACTOR, mode="hybrid",
                        num_roots=many, seed=SEED, graph=g, batched=True,
                        lanes=LANES)
    peak4 = torch.cuda.max_memory_allocated()
    roots4 = sample_roots(g, many, seed=SEED + 1)
    depth4 = msbfs_pipelined(g, roots4, "hybrid", lanes=LANES,
                             derive_parents=False).depth
    for r_i, r in enumerate(roots4):
        check(torch.equal(depth4[:, r_i], bfs(g, int(r), "hybrid").depth),
              f"refill run: lane {r_i} depth differs from serial bfs")
    del depth4

    serial = serial_res.aggregate_teps
    emit("batched", entry="repro_torch.graph.graph500.run_graph500",
         seconds=seconds, launches=launches, sweep_seconds=res.times[0],
         peak_mem_bytes=peak, serial_aggregate_teps=serial,
         aggregate_over_serial=res.aggregate_teps / serial,
         depth_parent_checked_lanes=len(roots), trace_checked_lanes=4,
         validated_lanes=min(8, len(roots)), oracle_lane=0,
         refill=dict(roots=many, lanes=LANES, sweep_seconds=res4.times[0],
                     aggregate_teps=res4.aggregate_teps,
                     harmonic_mean_teps=res4.harmonic_mean_teps,
                     peak_mem_bytes=peak4, depth_checked_lanes=many),
         **res.summary())
    check(all(t > 0 for t in res.teps), "a lane traversed no edges")
    return launches


def relax_cost(n, lanes, slots, finite, rows):
    # reads: row_ptr, one weight per live slot, the neighbour id of each
    # of the ``finite`` live slots with a finite weight, and each distinct
    # lane row those gather, once; writes: acc
    nbytes = (4 * (n + 1) + 4 * (slots + finite) + 4 * lanes * rows
              + 4 * n * lanes)
    return bound_ms(nbytes, 2 * finite * lanes)


def fallback_cost(n, lanes, slots, finite, rows, residue_rows):
    # reads: row_ptr, one weight per residue slot, the neighbour id of each
    # of the ``finite`` ones with a finite weight, each distinct lane row
    # those gather, once, and the base of the residue rows; writes: those
    # rows (rows without a residue are not touched)
    nbytes = (4 * (n + 1) + 4 * (slots + finite) + 4 * lanes * rows
              + 8 * residue_rows * lanes)
    return bound_ms(nbytes, 2 * finite * lanes)


def relax_plain(row_ptr, col_idx, w, vals, max_pos):
    """semiring_relax_ref on the kernel wrapper's arguments."""
    return semiring_relax_ref(row_ptr[:-1], row_ptr[1:] - row_ptr[:-1],
                              col_idx, w, vals, max_pos)


class RelaxKernelCheck:
    """semiring_relax and relax_fallback against their plain versions;
    keeps the cases, the largest difference, and the timed input's
    record. Outputs must be bit-equal (compared as int32 bit patterns)."""

    def __init__(self, wg):
        self.wg = wg
        self.rec = {name: dict(cases=0, max_abs_err=0.0)
                    for name in SSSP_KERNELS}
        pos = (torch.arange(wg.m, dtype=torch.int32, device=wg.device)
               - wg.row_ptr[wg.src_idx.long()])
        self.probe_slots = pos < MAX_POS
        self.residue_slots = ~self.probe_slots

    def _agree(self, name, label, k, r):
        check(torch.equal(k.view(torch.int32), r.view(torch.int32)),
              f"{name} differs from its plain version on {label}")
        fin = torch.isfinite(r)
        err = float((k[fin] - r[fin]).abs().max()) if bool(fin.any()) else 0.0
        self.rec[name]["cases"] += 1
        self.rec[name]["max_abs_err"] = max(self.rec[name]["max_abs_err"],
                                            err)

    def args(self, w, vals, acc=None):
        """(semiring_relax args, relax_fallback args on base ``acc``, which
        the fold updates in place)."""
        wg = self.wg
        return ((wg.row_ptr, wg.col_idx, w, vals, MAX_POS),
                (wg.row_ptr, wg.src_idx, wg.col_idx, w, vals, acc, MAX_POS))

    def relax(self, label, w, vals):
        ra, _ = self.args(w, vals)
        acc = semiring_relax_cuda(*ra)
        self._agree("semiring_relax", label, acc, relax_plain(*ra))
        _, fa = self.args(w, vals, acc)
        plain = relax_fallback_ref(*fa[:5], acc.clone(), MAX_POS)
        self._agree("relax_fallback", label, relax_fallback_cuda(*fa), plain)
        return ra, fa

    def gathered_rows(self, slots):
        return int(torch.unique(self.wg.col_idx[slots]).numel())

    def time_probe(self, label, ra, reps, flush):
        """semiring_relax's times on one input (``relax``'s args), its
        bound, and its library yardstick: one scatter_reduce(amin) over the
        probe slots' candidates, built outside the timing, into +inf."""
        wg = self.wg
        w, vals = ra[2], ra[3]
        lanes = vals.shape[1]
        probe = int(self.probe_slots.sum())
        fin = self.probe_slots & torch.isfinite(w)
        cost = relax_cost(wg.n, lanes, probe, int(fin.sum()),
                          self.gathered_rows(fin))
        slots = torch.nonzero(self.probe_slots).squeeze(1)
        cand = vals[wg.col_idx[slots].long()] + w[slots][:, None]
        index = wg.src_idx[slots].long()[:, None].expand(-1, lanes)
        empty = torch.full((wg.n, lanes), INF, device=wg.device)

        def library():
            return torch.scatter_reduce(empty, 0, index, cand, "amin")

        check(torch.equal(library(), semiring_relax_cuda(*ra)),
              f"the probe's library yardstick computes another function on "
              f"{label}")
        active = torch.isfinite(vals).any(dim=1)
        out = dict(ms=time_ms(lambda: semiring_relax_cuda(*ra), reps, flush),
                   plain_ms=time_ms(lambda: relax_plain(*ra), reps, flush),
                   library_ms=time_ms(library, reps, flush),
                   bound_ms=cost[0], bound_by=cost[1],
                   timed_input=dict(case=label, vertices=wg.n,
                                    probe_slots=probe,
                                    finite_probe_slots=int(fin.sum()),
                                    live_probe_slots=int(
                                        (fin & active[wg.col_idx.long()])
                                        .sum()),
                                    active_rows=int(active.sum())))
        del cand, index, slots, empty
        return out

    def time_fold(self, label, ra, fa, reps, flush):
        """relax_fallback's times on one input (``relax``'s args), its
        bound, and its library yardstick: one scatter_reduce(amin) over the
        residue slots' candidates, built outside the timing, from the
        probe's result. fa's base is folded first: a second fold finds
        nothing lower, so every timed run does the same work."""
        wg = self.wg
        w, vals = ra[2], ra[3]
        lanes = vals.shape[1]
        relax_fallback_cuda(*fa)
        acc = semiring_relax_cuda(*ra)
        slots = torch.nonzero(self.residue_slots).squeeze(1)
        cand = vals[wg.col_idx[slots].long()] + w[slots][:, None]
        index = wg.src_idx[slots].long()[:, None].expand(-1, lanes)

        def library():
            return torch.scatter_reduce(acc, 0, index, cand, "amin")

        check(torch.equal(library(), fa[5]),
              f"the fold's library yardstick computes another function on "
              f"{label}")
        active = torch.isfinite(vals).any(dim=1)
        fin = self.residue_slots & torch.isfinite(w)
        live = fin & active[wg.col_idx.long()]
        residue_rows = int((wg.deg > MAX_POS).sum())
        cost = fallback_cost(wg.n, lanes, slots.numel(), int(fin.sum()),
                             self.gathered_rows(fin), residue_rows)
        out = dict(ms=time_ms(lambda: relax_fallback_cuda(*fa), reps, flush),
                   plain_ms=time_ms(lambda: relax_fallback_ref(*fa), reps,
                                    flush),
                   library_ms=time_ms(library, reps, flush),
                   bound_ms=cost[0], bound_by=cost[1],
                   timed_input=dict(case=label, vertices=wg.n,
                                    residue_slots=slots.numel(),
                                    finite_residue_slots=int(fin.sum()),
                                    live_residue_slots=int(live.sum()),
                                    active_rows=int(active.sum()),
                                    residue_rows=residue_rows))
        del cand, index, slots
        return out


def phase_masks(wg, delta):
    """The light and heavy edge weights of bucket width ``delta``."""
    d32 = float(np.float32(delta))
    w = wg.weights
    return {"light": torch.where(w <= d32, w, INF),
            "heavy": torch.where(w > d32, w, INF)}


def relax_kernel_random(chk, dev, reps, flush, delta):
    """Both relax kernels on seeded random lane values (a quarter of the
    sources active) at L = 1, 3 and 32 under both weight masks; the L = 32
    heavy pass is timed, with the library yardstick for the fold."""
    wg = chk.wg
    n = wg.n
    for lanes in (1, 3, SSSP_LANES):
        rng = np.random.default_rng(SEED + lanes)
        vals = rng.uniform(0, 3, (n, lanes)).astype(np.float32)
        vals[rng.random((n, lanes)) >= 0.25] = np.inf
        vals = torch.from_numpy(vals).to(dev)
        for phase, w in phase_masks(wg, delta).items():
            ra, fa = chk.relax(f"random L={lanes} {phase}", w, vals)
        torch.cuda.synchronize()
        if lanes != SSSP_LANES:
            continue
        chk.rec["semiring_relax"].update(chk.time_probe(
            f"random L={lanes} heavy", ra, reps, flush))
        # every row has a finite lane and 97 % of the weights are finite
        # here, so nearly every residue slot gathers; the sweep's light and
        # heavy inputs (sssp_layers) show the fold on the engine's own data
        chk.rec["relax_fallback"].update(chk.time_fold(
            f"random L={lanes} heavy", ra, fa, reps, flush))


def sssp_layers(wg, roots, chk, reps, flush, delta, out_dir):
    """One sweep of the delta-stepping engine, one lane per source, step by
    step: the lanes in each phase, the host syncs of a step and its wall
    time, and each relax kernel's time on the step's own inputs (which go
    through both kernels against their plain versions on the first four
    steps and every 20th). relax_fallback is timed in full (plain version,
    library yardstick, bound) on the light and the heavy input of the
    first step from row SWEEP_TIMED_ROW on that has each."""
    s = sssp_engine_enqueue(sssp_engine_init(wg, len(roots), SSSP_LANES),
                            roots)
    rows = []
    while not sssp_engine_idle(s):
        s = prepare_step(wg, s, delta)
        p = plan_step(wg, s, delta)
        step = s.sweep_steps
        row = dict(step=step, active=int(p.active.sum()),
                   light_lanes=int(p.iterating.sum()),
                   settling_lanes=int(p.settling.sum()))
        row["syncs"] = syncs_of(lambda: sssp_engine_step(wg, s, delta))
        row["step_ms"] = wall_ms(lambda: sssp_engine_step(wg, s, delta), reps)
        relax_ms = 0.0
        for phase, w, vals in phase_inputs(wg, s, delta, p):
            if step < 4 or step % 20 == 0:
                chk.relax(f"sweep step {step} {phase}", w, vals)
            ra, _ = chk.args(w, vals)
            _, fa = chk.args(w, vals, semiring_relax_cuda(*ra))
            row[f"{phase}_sources"] = int(torch.isfinite(vals).sum())
            row[f"{phase}_probe_ms"] = time_ms(
                lambda: semiring_relax_cuda(*ra), reps, flush)
            row[f"{phase}_fold_ms"] = time_ms(
                lambda: relax_fallback_cuda(*fa), reps, flush)
            relax_ms += row[f"{phase}_probe_ms"] + row[f"{phase}_fold_ms"]
            sweep = chk.rec["relax_fallback"].setdefault("sweep_inputs", {})
            if len(rows) >= SWEEP_TIMED_ROW and phase not in sweep:
                sweep[phase] = chk.time_fold(f"sweep step {step} {phase}",
                                             ra, fa, reps, flush)
                chk.rec["semiring_relax"].setdefault("sweep_inputs", {})[
                    phase] = chk.time_probe(f"sweep step {step} {phase}",
                                            ra, reps, flush)
        row["relax_ms"] = relax_ms
        row["outside_relax_ms"] = row["step_ms"] - relax_ms
        rows.append(row)
        s = sssp_engine_step(wg, s, delta)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "sssp_layers.json"), "w") as f:
            json.dump(rows, f)
    relaxes = sum(("light_probe_ms" in r) + ("heavy_probe_ms" in r)
                  for r in rows)

    def median_of(key):
        vals = [r[key] for r in rows if key in r]
        return statistics.median(vals) if vals else None
    emit("sssp_layers", sources=len(roots), lanes=SSSP_LANES, delta=delta,
         steps=len(rows), relaxes=relaxes,
         light_steps=sum("light_probe_ms" in r for r in rows),
         heavy_steps=sum("heavy_probe_ms" in r for r in rows),
         step_ms_total=sum(r["step_ms"] for r in rows),
         relax_ms_total=sum(r["relax_ms"] for r in rows),
         probe_ms_total=sum(r.get("light_probe_ms", 0) + r.get(
             "heavy_probe_ms", 0) for r in rows),
         fold_ms_total=sum(r.get("light_fold_ms", 0) + r.get(
             "heavy_fold_ms", 0) for r in rows),
         probe_ms_median={p: median_of(f"{p}_probe_ms")
                          for p in ("light", "heavy")},
         fold_ms_median={p: median_of(f"{p}_fold_ms")
                         for p in ("light", "heavy")},
         outside_relax_ms_total=sum(r["outside_relax_ms"] for r in rows),
         syncs_per_step=sorted(set(r["syncs"] for r in rows)),
         rows_every_10th=rows[::10])


def dijkstra_check(wg, roots, dist, lanes: int = 4) -> float:
    """The first ``lanes`` lanes against scipy's Dijkstra in float64, on a
    copy that keeps one edge per (u, v): the CSR keeps parallel edges, each
    row sorted by (neighbour, weight), so the first of a run is the
    lightest. Returns the largest difference; raises past 1e-4."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import dijkstra
    rp, ci, w = to_numpy_weighted(wg)
    src = np.repeat(np.arange(wg.n), np.diff(rp))
    keep = np.ones(wg.m, bool)
    keep[1:] = (src[1:] != src[:-1]) | (ci[1:] != ci[:-1])
    a = sp.csr_matrix((w[keep].astype(np.float64), (src[keep], ci[keep])),
                      shape=(wg.n, wg.n))
    want = dijkstra(a, indices=[int(r) for r in roots[:lanes]])
    got = dist[:, :lanes].cpu().numpy().T.astype(np.float64)
    check(np.array_equal(np.isfinite(got), np.isfinite(want)),
          "SSSP reached sets differ from Dijkstra")
    fin = np.isfinite(want)
    err = float(np.abs(got[fin] - want[fin]).max()) if fin.any() else 0.0
    check(err <= 1e-4, f"SSSP distances differ from Dijkstra by {err}")
    return err


def run_sssp_path(wg, args):
    """The delta-stepping engine through its entry point, then its checks.
    Returns (launches of the 32-source run, its engine steps)."""
    many = sample_roots(wg, 2 * args.sources, seed=SEED + 1)
    roots = many[:args.sources]
    delta = default_delta(wg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    common.reset_launches()
    t0 = time.perf_counter()
    res = sssp_pipelined(wg, roots, lanes=SSSP_LANES)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(common.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    for name in SSSP_KERNELS:
        check(launches[name] > 0, f"{name} was not launched on the SSSP path")
    check(not bool(res.truncated.any()), "an SSSP lane was truncated")
    check(res.dist.shape == (wg.n, len(roots)), "SSSP dist has another shape")
    steps = res.steps.tolist()
    sweep_steps = max(steps)     # sources <= lanes: all start on step one

    # twice the sources through the same lanes: the first ones' answers are
    # the same bits, whatever lane served them and whenever
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res2 = sssp_pipelined(wg, many, lanes=SSSP_LANES)
    torch.cuda.synchronize()
    seconds2 = time.perf_counter() - t0
    peak2 = torch.cuda.max_memory_allocated()
    k = len(roots)
    check(not bool(res2.truncated.any()), "a refill-run lane was truncated")
    for name, a, b in zip(res._fields, res2, res):
        a = a[:, :k] if a.dim() == 2 else a[:k]
        if a.is_floating_point():
            a, b = a.view(torch.int32), b.view(torch.int32)
        check(torch.equal(a, b),
              f"refill run: {name} differs from the {k}-source run")
    err = dijkstra_check(wg, roots, res.dist)

    # the unit-weight anchor: delta = 1 walks BFS layers
    unit = unit_weight_graph(wg)
    depth = sssp_pipelined(unit, roots, delta=1.0,
                           lanes=SSSP_LANES).as_depth()
    want = msbfs_pipelined(unit.csr, roots, "hybrid", lanes=SSSP_LANES,
                           derive_parents=False).depth
    check(torch.equal(depth, want),
          "unit-weight SSSP depths differ from msbfs_pipelined")
    points = bench_points(args.scale, EDGEFACTOR, SEED, args.sources,
                          SSSP_LANES, graph=wg, unit=unit)
    finite = res.dist[torch.isfinite(res.dist)]
    emit("sssp", entry="repro_torch.traversal.sssp.sssp_pipelined",
         sources=k, lanes=SSSP_LANES, delta=delta, seconds=seconds,
         launches=launches, sweep_steps=sweep_steps,
         steps_min=min(steps), steps_median=float(np.median(steps)),
         steps_max=max(steps), peak_mem_bytes=peak,
         max_dist=float(finite.max()),
         reached_per_lane_median=float(torch.isfinite(res.dist).sum(
             dim=0).float().median()),
         refill=dict(sources=len(many), lanes=SSSP_LANES, seconds=seconds2,
                     peak_mem_bytes=peak2, checked_sources=k,
                     steps_max=int(res2.steps.max())),
         dijkstra_lanes=4, dijkstra_max_abs_err=err,
         unit_weight_anchor_lanes=k, teps=points)
    return launches, sweep_steps, points


def f32_bound(abs_sum64, deg):
    """Float32's summation bound for rows of ``deg`` terms against their
    float64 sum: 2 * deg * 2**-24 * sum |x_u| + 1e-7."""
    return 2.0 * deg.double()[:, None] * 2.0 ** -24 * abs_sum64 + 1e-7


def slab_cost(n, k_max, slots, n_src, d):
    # reads: the ids and flags of every slot, each gathered source row once
    # (at most all of x); writes: y
    nbytes = 5 * n * k_max + 4 * d * min(slots, n_src) + 4 * n * d
    return bound_ms(nbytes, slots * d)


def residue_cost(n, tail_slots, tail_rows, n_src, d):
    # reads: row_ptr, each tail slot's id, each gathered source row once,
    # the residue rows of y; writes: those rows of y
    nbytes = (4 * (n + 1) + 4 * tail_slots + 4 * d * min(tail_slots, n_src)
              + 8 * d * tail_rows)
    return bound_ms(nbytes, tail_slots * d)


def library_csrs(g, neigh, valid, k_max, n_src):
    """The slab and the tail as CSR sparse tensors of ones, for
    torch.sparse.mm (cuSPARSE): the library yardsticks of the two kernels,
    built outside the timing and used nowhere in the port."""
    n, dev = g.n, g.device
    crow = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    torch.cumsum(valid.sum(dim=1), 0, out=crow[1:])
    cols = neigh[valid].long()
    slab = torch.sparse_csr_tensor(
        crow, cols, torch.ones(cols.numel(), device=dev), size=(n, n_src))
    pos = torch.arange(g.m, device=dev) - g.row_ptr[g.src_idx.long()]
    tcols = g.col_idx[pos >= k_max].long()
    tcrow = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    torch.cumsum((g.deg - k_max).clamp(min=0), 0, out=tcrow[1:])
    tail = torch.sparse_csr_tensor(
        tcrow, tcols, torch.ones(tcols.numel(), device=dev), size=(n, n_src))
    return slab, tail


class GnnKernelCheck:
    """ell_spmm against its plain version in float32 (the same bits: both
    sum each row in slot order) and spmm_residue against its plain version
    taken in float64, within float32's summation bound (ell_spmm's float64
    bound ratio is kept beside its check); keeps the cases, the largest
    error and ratio to the bound, and the times of each timed input."""

    def __init__(self, phase: str = "gnn_kernel"):
        self.phase = phase
        self.rec = {name: dict(cases=0, max_abs_err=0.0, max_bound_ratio=0.0)
                    for name in GNN_KERNELS}
        self.rec["ell_spmm"].update(bit_equal_f32=True, max_abs_err_f64=0.0)
        self.rows = []

    def _agree(self, name, label, got, want, abs_sum, deg):
        err = (got.double() - want).abs()
        ratio = float((err / f32_bound(abs_sum, deg)).max()) \
            if err.numel() else 0.0
        check(ratio <= 1.0, f"{name} exceeds float32's summation bound on "
                            f"{label} (ratio {ratio})")
        r = self.rec[name]
        r["cases"] += 1
        key = "max_abs_err_f64" if name == "ell_spmm" else "max_abs_err"
        r[key] = max(r[key], float(err.max()) if err.numel() else 0.0)
        r["max_bound_ratio"] = max(r["max_bound_ratio"], ratio)
        return ratio

    def run(self, label, g, neigh, valid, x, k_max, reps, flush,
            timed=False):
        """Both kernels on one input; times them when ``reps``."""
        n, n_src, d = neigh.shape[0], x.shape[0], x.shape[1]
        deg = g.deg[:n]
        y = ell_spmm_cuda(neigh, valid, x)
        check(torch.equal(ell_spmm_cuda(neigh, valid, x), y),
              f"ell_spmm is not deterministic on {label}")
        plain32 = ell_spmm_ref(neigh, valid, x)
        check(torch.equal(y.view(torch.int32), plain32.view(torch.int32)),
              f"ell_spmm differs from its float32 plain version on {label}")
        self.rec["ell_spmm"]["max_abs_err"] = max(
            self.rec["ell_spmm"]["max_abs_err"],
            float((y - plain32).abs().max()) if y.numel() else 0.0)
        del plain32
        x64 = x.double()
        slab = ell_spmm_ref(neigh, valid, x64)
        slab_abs = ell_spmm_ref(neigh, valid, x64.abs())
        row = dict(case=label, n=n, n_src=n_src, d=d, k_max=k_max)
        row["ell_spmm_bound_ratio"] = self._agree(
            "ell_spmm", label, y, slab, slab_abs, deg.clamp(max=k_max))
        y2 = y.clone()
        spmm_residue_cuda(g.row_ptr, g.src_idx, g.col_idx, x, y, k_max)
        spmm_residue_cuda(g.row_ptr, g.src_idx, g.col_idx, x, y2, k_max)
        check(torch.equal(y, y2), f"spmm_residue is not deterministic on "
                                  f"{label}")
        full = spmm_residue_ref(g.row_ptr, g.src_idx, g.col_idx, x64, slab,
                                k_max)
        full_abs = spmm_residue_ref(g.row_ptr, g.src_idx, g.col_idx,
                                    x64.abs(), slab_abs, k_max)
        row["spmm_residue_bound_ratio"] = self._agree(
            "spmm_residue", label, y, full, full_abs, deg)
        del x64, slab, slab_abs, full, full_abs, y2
        slots = int(valid.sum())
        tail_slots = int((deg - k_max).clamp(min=0).sum())
        tail_rows = int((deg > k_max).sum())
        row.update(slab_slots=slots, tail_slots=tail_slots,
                   tail_rows=tail_rows, max_deg=int(deg.max()))
        if reps:
            lib_slab, lib_tail = library_csrs(g, neigh, valid, k_max, n_src)
            # the library and the plain version both sum in float32, each
            # in its own order: each is within the bound of the exact sum
            def tail_of(t):
                return spmm_residue_ref(g.row_ptr, g.src_idx, g.col_idx, t,
                                        torch.zeros_like(y), k_max)
            for lib, plain, terms in (
                    (lib_slab, lambda t: ell_spmm_ref(neigh, valid, t),
                     deg.clamp(max=k_max)),
                    (lib_tail, tail_of, (deg - k_max).clamp(min=0))):
                err = (torch.sparse.mm(lib, x) - plain(x)).abs().double()
                ratio = float((err / (2 * f32_bound(
                    plain(x.abs()).double(), terms))).max())
                check(ratio <= 1.0, f"a library yardstick computes another "
                                    f"function on {label} (ratio {ratio})")
            costs = dict(ell_spmm=slab_cost(n, k_max, slots, n_src, d),
                         spmm_residue=residue_cost(n, tail_slots, tail_rows,
                                                   n_src, d))
            calls = dict(
                ell_spmm=(lambda: ell_spmm_cuda(neigh, valid, x),
                          lambda: ell_spmm_ref(neigh, valid, x),
                          lambda: torch.sparse.mm(lib_slab, x)),
                spmm_residue=(
                    lambda: spmm_residue_cuda(g.row_ptr, g.src_idx,
                                              g.col_idx, x, y, k_max),
                    lambda: spmm_residue_ref(g.row_ptr, g.src_idx,
                                             g.col_idx, x, y, k_max),
                    lambda: torch.sparse.mm(lib_tail, x)))
            for name, (kern, plain, lib) in calls.items():
                t = dict(ms=time_ms(kern, reps, flush),
                         plain_ms=time_ms(plain, max(reps // 4, 3), flush),
                         library_ms=time_ms(lib, reps, flush),
                         bound_ms=costs[name][0], bound_by=costs[name][1])
                row[name] = t
                self.rec[name].setdefault("inputs", []).append(
                    dict(case=label, **t))
                if timed:
                    self.rec[name].update(t, timed_input=label)
            del lib_slab, lib_tail
        self.rows.append(row)
        emit(self.phase, **row)


def nonzero_csr(rows, cols, mask, n) -> CSRGraph:
    """The CSR that ``core/csr.py::from_edge_tensors`` gave before it kept
    dead slots: the
    masked edges dropped first with ``nonzero`` (a host read of the kept
    count), then the same stable sort by row. The oracle of the fixed-size
    CSR's live part, and the nonzero adjacency of ``gcn_layers``."""
    keep = mask.nonzero().squeeze(1)
    rows, cols = rows[keep], cols[keep]
    src, order = torch.sort(rows.to(torch.int32), stable=True)
    bounds = torch.arange(n + 1, dtype=torch.int32, device=src.device)
    return CSRGraph(row_ptr=torch.searchsorted(src, bounds, out_int32=True),
                    col_idx=cols.to(torch.int32)[order], src_idx=src)


def masked_batch(gb, seed):
    """``gb`` with a seeded MASKED_SHARE of its edges masked."""
    gen = torch.Generator(device=gb.edge_mask.device).manual_seed(seed)
    drop = torch.rand(gb.n_edges, generator=gen,
                      device=gb.edge_mask.device) < MASKED_SHARE
    return gb._replace(edge_mask=gb.edge_mask & ~drop)


def masked_kernels(phase, gb, widths, seed) -> dict:
    """B5 and X3 over both CSRs of ``masked_batch(gb, seed)``, whose masked
    edges are dead slots past ``row_ptr[n]``: each CSR's live part equal
    to ``nonzero_csr``'s, and at each width in ``widths`` (a seeded x) the
    slab sum bit-equal to its float32 plain version, the residue to its
    slot-order plain version, and the two together to the kernels over
    ``nonzero_csr``'s CSR (the bits before dead slots). Emits and returns
    the record."""
    gbm = masked_batch(gb, seed)
    adj = build_adjacency(gbm)
    n, e = gbm.n_nodes, gbm.n_edges
    live = int(gbm.edge_mask.sum())
    gen = torch.Generator(device=gbm.feats.device).manual_seed(seed + 1)
    cases = []
    for name, g, ell, rows, cols in (
            ("fwd", adj.fwd, adj.fwd_ell, gbm.receivers, gbm.senders),
            ("bwd", adj.bwd, adj.bwd_ell, gbm.senders, gbm.receivers)):
        old = nonzero_csr(rows, cols, gbm.edge_mask, n)
        check(g.m == e and old.m == live == int(g.row_ptr[n])
              and torch.equal(g.row_ptr, old.row_ptr)
              and torch.equal(g.col_idx[:live], old.col_idx)
              and torch.equal(g.src_idx[:live], old.src_idx)
              and bool((g.src_idx[live:] == n).all()),
              f"the masked {name} CSR's live part differs from "
              f"nonzero_csr's")
        tail = int((g.deg - ELL_K_MAX).clamp(min=0).max())
        check(tail <= RESIDUE_LONG_TAIL, f"the masked {name} CSR has a tail "
                                         f"of {tail} slots, past the row pass")
        old_ell = ell_pad(old, ELL_K_MAX)
        for d in widths:
            x = torch.randn((n, d), generator=gen, device=gbm.feats.device)
            y = ell_spmm_cuda(*ell, x)
            check(torch.equal(y.view(torch.int32),
                              ell_spmm_ref(*ell, x).view(torch.int32)),
                  f"ell_spmm differs from its plain version on the masked "
                  f"{name} CSR at d={d}")
            want = residue_slot_order(g, x, y, ELL_K_MAX)
            got = spmm_residue_cuda(g.row_ptr, g.src_idx, g.col_idx, x, y,
                                    ELL_K_MAX)
            check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
                  f"spmm_residue differs from its slot-order plain version "
                  f"on the masked {name} CSR at d={d}")
            before = spmm_aggregate(old, x, ELL_K_MAX, old_ell)
            check(torch.equal(got.view(torch.int32),
                              before.view(torch.int32)),
                  f"the kernels over the masked {name} CSR differ from the "
                  f"nonzero CSR at d={d}")
            cases.append(f"{name} d={d}")
            del x, y, want, got, before
        del old, old_ell
    rec = dict(part="masked", n=n, edges=e, live_edges=live,
               dead_slots=e - live, masked_share=MASKED_SHARE, cases=cases,
               bit_equal=True)
    emit(phase, **rec)
    return rec


def gnn_launches(arch, shape_id) -> dict:
    """Launches of each aggregation kernel in one train step of gcn-cora or
    gin-tu at ``shape_id``: ell_spmm one a call, spmm_residue
    ``residue_launches(d)`` a call at the call's width d. GCN aggregates
    each layer's output (d_hidden, then n_classes), forward and backward;
    GIN each layer's input, n_layers forward (layer 0 at d_feat) and
    n_layers - 1 backward (layer 0's features need no gradient)."""
    cfg = effective_cfg(arch, arch.shape(shape_id))
    if type(cfg).__name__ == "GCNConfig":
        out = [cfg.d_hidden] * (cfg.n_layers - 1) + [cfg.n_classes]
        widths = 2 * out
    else:
        widths = [cfg.d_feat] + [cfg.d_hidden] * (2 * cfg.n_layers - 2)
    return {"ell_spmm": len(widths),
            "spmm_residue": sum(residue_launches(d) for d in widths)}


def gnn_kernel(chk, g_rmat, dev, reps, flush):
    """Both kernels on a seeded ogb_products-shaped batch's aggregation
    graph and its transpose (the GCN step's four shapes: forward and
    transposed graph at d = 16, the kernels line's timed input, and 47), a
    row subset of the forward graph at d = 100 against all its source rows,
    and the scale-20 R-MAT graph at d = 16, whose hubs give spmm_residue
    long tails; then the batch with a quarter of its edges masked
    (``masked_kernels`` at d = 100: dead slots in both CSRs)."""
    arch = get_arch("gcn-cora")
    shape = arch.shape("ogb_products")
    gb = gnn_batch(arch, shape, 0, seed=SEED + 2, device=dev)
    masked_kernels("gnn_kernel", gb, (100,), SEED + 7)
    adj = build_adjacency(gb)
    n = gb.n_nodes
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    del gb
    for d in (16, 47):
        x = torch.randn((n, d), generator=gen, device=dev)
        chk.run(f"ogb_products fwd d={d}", adj.fwd, *adj.fwd_ell, x,
                adj.k_max, reps, flush, timed=d == 16)
        chk.run(f"ogb_products bwd d={d}", adj.bwd, *adj.bwd_ell, x,
                adj.k_max, reps, flush)
    rows = min(1 << 18, n)
    ends = int(adj.fwd.row_ptr[rows])
    sub = CSRGraph(adj.fwd.row_ptr[:rows + 1], adj.fwd.col_idx[:ends],
                   adj.fwd.src_idx[:ends])
    x = torch.randn((n, 100), generator=gen, device=dev)
    chk.run(f"ogb_products fwd rows<{rows} d=100", sub,
            adj.fwd_ell[0][:rows], adj.fwd_ell[1][:rows], x, adj.k_max, 0,
            flush)
    del adj, x, sub
    x = torch.randn((g_rmat.n, 16), generator=gen, device=dev)
    neigh, valid = ell_pad(g_rmat, ELL_K_MAX)
    chk.run("rmat scale-20 d=16", g_rmat, neigh, valid, x, ELL_K_MAX, reps,
            flush)
    for name, r in chk.rec.items():
        emit("gnn_kernel", name=name, **r)


def gcn_layers(dev, reps, flush):
    """Where one gcn-cora training step at ogb_products spends its time:
    step_breakdown's record, then the kernels' launches and device ms in a
    step and the step's host syncs, beside the syncs of the same step over
    the nonzero adjacency (``nonzero_csr``: one sync a CSR, two an
    ``edge_adjacency`` call) and the adjacency build's and the step's wall
    ms over both, 3 times in turns; on a masked batch, the step's loss and
    gradients over both adjacencies (the same bits) and ``masked_kernels``
    at the step's four shapes."""
    arch = get_arch("gcn-cora")
    shape = arch.shape("ogb_products")
    cfg = effective_cfg(arch, shape)
    out, (params, opt_state, step, gb) = step_breakdown(
        arch, shape.shape_id, dev, reps)
    out.update(n=shape.dims["n_nodes"], e=shape.dims["n_edges"],
               d_feat=cfg.d_feat, d_hidden=cfg.d_hidden,
               n_classes=cfg.n_classes)
    common.reset_launches()
    step(params, opt_state, gb)
    torch.cuda.synchronize()
    out["launches_per_step"] = {k: common.LAUNCHES[k] for k in GNN_KERNELS}
    builds = []

    def counted(*a, **kw):
        builds.append(1)
        return edge_adjacency(*a, **kw)
    with mock.patch.object(gnn_common, "edge_adjacency", counted):
        out["syncs_per_step"] = syncs_of(lambda: step(params, opt_state, gb))
    with mock.patch.object(gnn_common, "from_edge_tensors", nonzero_csr):
        out["nonzero_syncs_per_step"] = syncs_of(
            lambda: step(params, opt_state, gb))
    out["adjacency_builds_per_step"] = len(builds)
    # the adjacency build and the step over both adjacencies, in turns
    turns = {"adjacency_ms": [], "nonzero_adjacency_ms": [], "step_ms": [],
             "nonzero_step_ms": []}
    for _ in range(3):
        for old in (False, True):
            with (mock.patch.object(gnn_common, "from_edge_tensors",
                                    nonzero_csr)
                  if old else contextlib.nullcontext()):
                pre = "nonzero_" if old else ""
                turns[pre + "adjacency_ms"].append(
                    wall_ms(lambda: build_adjacency(gb), reps))
                turns[pre + "step_ms"].append(
                    wall_ms(lambda: step(params, opt_state, gb), reps))
    out["in_turns"] = turns
    check(out["nonzero_syncs_per_step"] - out["syncs_per_step"]
          == 2 * len(builds) > 0,
          f"a gcn step makes {out['syncs_per_step']} host syncs, the "
          f"nonzero adjacency {out['nonzero_syncs_per_step']}, over "
          f"{len(builds)} adjacency builds")
    gbm = masked_batch(gb, SEED + 8)
    runs = []
    for patch in (contextlib.nullcontext(), mock.patch.object(
            gnn_common, "from_edge_tensors", nonzero_csr)):
        with patch:
            loss, grads = loss_grads(lambda p, b: gcn_loss(p, b, cfg),
                                     params, gbm)
        runs.append([loss] + grads)
    check(all(torch.equal(a, b) for a, b in zip(*runs)),
          "a gcn step on a masked batch differs over the nonzero adjacency")
    out["masked_step_bit_equal"] = True
    del runs, gbm
    out["masked"] = masked_kernels("gcn_layers", gb,
                                   (cfg.d_hidden, cfg.n_classes), SEED + 9)
    # each kernel at the step's four shapes: forward and transposed graph,
    # d = d_hidden (layer 0) and n_classes (layer 1)
    adj = build_adjacency(gb)
    per = {k: 0.0 for k in GNN_KERNELS}
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    for d in (cfg.d_hidden, cfg.n_classes):
        x = torch.randn((gb.n_nodes, d), generator=gen, device=dev)
        for g, (neigh, valid) in ((adj.fwd, adj.fwd_ell),
                                  (adj.bwd, adj.bwd_ell)):
            y = ell_spmm_cuda(neigh, valid, x)
            per["ell_spmm"] += time_ms(
                lambda: ell_spmm_cuda(neigh, valid, x), reps, flush)
            per["spmm_residue"] += time_ms(
                lambda: spmm_residue_cuda(g.row_ptr, g.src_idx, g.col_idx,
                                          x, y, adj.k_max), reps, flush)
    out["kernel_ms_per_step"] = per
    # spmm_residue's scratch, allocated anew by each call: the largest
    out["spmm_residue_scratch_bytes"] = max(
        residue_scratch(g.m, d)[1] for g in (adj.fwd, adj.bwd)
        for d in (cfg.d_hidden, cfg.n_classes))
    emit("gcn_layers", **out)
    want = gnn_launches(arch, shape.shape_id)
    check(out["launches_per_step"] == want,
          f"a gcn step launched {out['launches_per_step']}, not {want}")
    return out


def rel_diff(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def loss_grads(loss_fn, params, batch):
    """(loss, gradients) of ``loss_fn(leaves, batch)`` at ``params``: the
    gradients in the order of ``params``, zeros where a leaf is unused."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    loss, _ = loss_fn(leaves, batch)
    got = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return loss.detach(), [torch.zeros_like(v) if g is None else g
                           for v, g in zip(leaves.values(), got)]


def kernel_vs_plain(tr, loss, dev) -> list[float]:
    """The loss and gradients of ``loss(params, batch, cfg, adj, impl)`` at
    the trainer's parameters on its shape's step-0 batch, on the kernels
    (spmm_aggregate) against the plain aggregation (spmm_aggregate_ref) on
    the same card: each within 1e-4 of the plain tensor's largest
    magnitude. Returns those relative differences, the loss's first."""
    cfg = effective_cfg(tr.arch, tr.shape)
    gb = gnn_batch(tr.arch, tr.shape, 0, seed=SEED, device=dev)
    adj = build_adjacency(gb)
    runs = []
    for impl in (spmm_aggregate, spmm_aggregate_ref):
        loss_v, grads = loss_grads(
            lambda p, b: loss(p, b, cfg, adj, impl), tr.params, gb)
        runs.append([loss_v] + grads)
    diffs = [rel_diff(a, b) for a, b in zip(*runs)]
    check(max(diffs) <= 1e-4,
          f"kernel and plain {tr.arch.arch_id} steps differ: {diffs}")
    return diffs


def run_gcn_path(dev):
    """The Trainer on gcn-cora at ogb_products (1 warm-up step and 5
    timed), with the launch counts of that run alone; then one step's loss
    and gradients on the kernels against the plain aggregation on the same
    card, and kill-and-resume at full_graph_sm. Returns the launches."""
    arch = get_arch("gcn-cora")
    tr, run = trainer_run(arch, "ogb_products", GCN_STEPS, dev,
                          per_step=gnn_launches(arch, "ogb_products"))
    diffs = kernel_vs_plain(tr, gcn_loss, dev)
    del tr

    # kill-and-resume at full_graph_sm: 6 steps = 3, restart, 3 more
    with tempfile.TemporaryDirectory() as tmp:
        def trainer(steps, sub, every):
            return Trainer(arch, "full_graph_sm", cfg=TrainerConfig(
                steps=steps, ckpt_every=every, log_every=1, seed=SEED,
                ckpt_dir=os.path.join(tmp, sub)))
        log_a = trainer(6, "a", 100).run()
        trainer(3, "b", 3).run()
        resumed = trainer(6, "b", 100)
        log_b = resumed.run()
    check(log_b[0]["step"] == 4, "the resumed run did not restart at step 4")
    check(log_a[-1]["loss"] == log_b[-1]["loss"],
          "kill-and-resume changed the final loss")
    emit("gcn_train", entry="repro_torch.train.trainer.Trainer.run",
         arch="gcn-cora", shape="ogb_products", steps=GCN_STEPS, **run,
         kernel_vs_plain_rel_diff=dict(loss=diffs[0], grads=diffs[1:]),
         kill_resume=dict(shape="full_graph_sm", steps=6,
                          final_loss=log_a[-1]["loss"], exact=True))
    return run["launches"]


def residue_slot_order(g, x, y, k_max):
    """The residue fold in plain PyTorch, summed as spmm_residue.cu's row
    pass sums a tail of at most RESIDUE_LONG_TAIL slots: the row's tail
    slots in slot order from 0.0, added to y once; rows without a tail keep
    y. A new tensor."""
    deg = g.deg
    n_src = x.shape[0]
    tail = torch.zeros_like(y)
    for pos in range(k_max, int(deg.max()) if g.n else k_max):
        rows = (deg > pos).nonzero().squeeze(1)
        cols = g.col_idx[(g.row_ptr[rows] + pos).long()].long()
        tail[rows] = tail[rows] + x[cols.clamp(0, n_src - 1)]
    out = y.clone()
    has = deg > k_max
    out[has] = out[has] + tail[has]
    return out


def gin_kernel_inputs(dev):
    """GIN's aggregation inputs on seeded gin-tu batches: (label, graph,
    slab, x) with x the layer-0 features or a seeded hidden-width
    tensor."""
    arch = get_arch("gin-tu")
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    for shape_id, hidden in (("ogb_products", True), ("minibatch_lg", False),
                             ("full_graph_sm", False)):
        gb = gnn_batch(arch, arch.shape(shape_id), 0, seed=SEED + 5,
                       device=dev)
        adj = build_adjacency(gb)
        d = gb.feats.shape[1]
        yield f"gin {shape_id} fwd d={d}", adj.fwd, adj.fwd_ell, gb.feats
        if hidden:
            h = torch.randn((gb.n_nodes, arch.model_cfg.d_hidden),
                            generator=gen, device=dev)
            for name, g, ell in (("fwd", adj.fwd, adj.fwd_ell),
                                 ("bwd", adj.bwd, adj.bwd_ell)):
                yield (f"gin {shape_id} {name} d={h.shape[1]}", g, ell, h)
        del gb, adj


def gin_kernels(chk, dev, reps, flush):
    """Both kernels on each of GIN's inputs: chk's checks (ell_spmm
    bit-equal to its float32 plain version, spmm_residue within float32's
    bound of its float64 plain version) and times, and spmm_residue
    bit-equal to residue_slot_order, which needs every tail within the row
    pass (at most RESIDUE_LONG_TAIL slots)."""
    for label, g, (neigh, valid), x in gin_kernel_inputs(dev):
        tail = int((g.deg - ELL_K_MAX).clamp(min=0).max())
        check(tail <= RESIDUE_LONG_TAIL, f"{label} has a tail of {tail} "
                                         f"slots, past the row pass")
        y = ell_spmm_cuda(neigh, valid, x)
        want = residue_slot_order(g, x, y, ELL_K_MAX)
        got = spmm_residue_cuda(g.row_ptr, g.src_idx, g.col_idx, x, y,
                                ELL_K_MAX)
        check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
              f"spmm_residue differs from its slot-order plain version on "
              f"{label}")
        del y, want, got
        chk.run(label, g, neigh, valid, x, ELL_K_MAX, reps, flush)
    for name, r in chk.rec.items():
        emit("gnn_zoo", part="kernels", name=name,
             residue_bit_equal=name == "spmm_residue", **r)


def trainer_run(arch, shape_id, steps, dev, per_step=None):
    """The Trainer's run with the launch counts and peak memory of that
    run alone: (trainer, record). Every loss must be finite and every
    grad_norm above 0. Every grad_norm must be finite too, except where
    NORM_OVERFLOWS lists the run and norm_overflow_witness shows that only
    the float32 sum of squares overflowed. ``per_step``: the launches each
    GNN kernel must make a step (``gnn_launches``), by kernel."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    common.reset_launches()
    t0 = time.perf_counter()
    tr = Trainer(arch, shape_id, cfg=TrainerConfig(
        steps=steps, log_every=1, seed=SEED))
    log = quiet(tr.run)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: v for k, v in common.LAUNCHES.items() if v}
    peak = torch.cuda.max_memory_allocated() - base
    name = f"{arch.arch_id} at {shape_id}"
    check(tr.device.type == "cuda", "the Trainer did not run on the GPU")
    if per_step is not None:
        for k in GNN_KERNELS:
            check(launches.get(k) == per_step[k] * steps,
                  f"{k} launched {launches.get(k, 0)} times in {steps} "
                  f"{name} steps, not {per_step[k]} a step")
    losses = [m["loss"] for m in log]
    norms = [m["grad_norm"] for m in log]
    check(len(log) == steps and all(np.isfinite(losses)),
          f"a {name} loss is not finite")
    check(all(v > 0 for v in norms), f"a {name} grad_norm is 0 or NaN")
    walls = [0.0] + [m["wall"] for m in log]
    step_ms = [(b - a) * 1e3 for a, b in zip(walls, walls[1:])]
    run = dict(seconds=seconds, launches=launches,
               launches_per_step={k: v / steps for k, v in launches.items()},
               step_ms=step_ms,
               timed_step_ms_median=statistics.median(step_ms[1:]),
               timed_step_ms_max=max(step_ms[1:]), peak_mem_bytes=peak,
               losses=losses, grad_norms=norms)
    if not all(np.isfinite(norms)):
        check((arch.arch_id, shape_id) in NORM_OVERFLOWS,
              f"a {name} grad_norm is not finite: {norms}")
        run["norm_witness"] = norm_overflow_witness(arch, shape_id, log,
                                                    dev)
    return tr, run


def norm_overflow_witness(arch, shape_id, log, dev) -> dict:
    """Replays the Trainer's run (its seed's parameters and batches, the
    same step) and takes each step's gradients again before the step: every
    element must be finite and their norm in float64 finite and above 0;
    where the Trainer's grad_norm was not finite, the float32 norm that
    clip_by_global_norm computes must not be finite either. That shows the
    inf is the float32 sum of squares overflowing, not the gradient.
    Returns both norms a step and the largest gradient element."""
    shape = arch.shape(shape_id)
    init_fn, loss_fn = param_builders(arch, shape)
    params = {k: v.to(dev) for k, v in init_fn(
        torch.Generator().manual_seed(SEED)).items()}
    opt_state = init_opt_state(params, arch.opt)
    step = make_step(arch, shape)
    out = dict(grad_norm_f64=[], grad_norm_f32=[], max_abs_grad=[])
    for s, m in enumerate(log):
        batch = make_batch(arch, shape, s, seed=SEED, device=dev)
        _, grads = loss_grads(loss_fn, params, batch)
        bad = [k for k, g in zip(params, grads)
               if not bool(torch.isfinite(g).all())]
        check(not bad, f"{arch.arch_id} at {shape_id}, step {s + 1}: "
                       f"gradients not finite: {bad}")
        f64 = float(torch.stack([g.double().square().sum()
                                 for g in grads]).sum().sqrt())
        f32 = float(global_norm(dict(zip(params, grads))))
        check(np.isfinite(f64) and f64 > 0
              and (np.isfinite(m["grad_norm"]) or not np.isfinite(f32)),
              f"{arch.arch_id} at {shape_id}, step {s + 1}: grad norm "
              f"{f64} in float64, {f32} in float32, the Trainer's "
              f"{m['grad_norm']}")
        out["grad_norm_f64"].append(f64)
        out["grad_norm_f32"].append(f32)
        out["max_abs_grad"].append(max(float(g.abs().max()) for g in grads))
        params, opt_state, _ = step(params, opt_state, batch)
    return out


def run_gnn_zoo(dev, smi, reps, flush):
    """The gnn_zoo phase. Returns GIN's record for the kernels line."""
    chk = GnnKernelCheck("gnn_zoo")
    gin_kernels(chk, dev, reps, flush)
    gin = get_arch("gin-tu")
    runs = {}
    for shape_id in ("ogb_products", "full_graph_sm"):
        tr, run = trainer_run(gin, shape_id, GCN_STEPS, dev,
                              per_step=gnn_launches(gin, shape_id))
        runs[shape_id] = run
        emit("gnn_zoo", part="gin_train", card=smi, arch="gin-tu",
             shape=shape_id, steps=GCN_STEPS, **run)
        if shape_id == "ogb_products":
            diffs = kernel_vs_plain(tr, gin_loss, dev)
            emit("gnn_zoo", part="gin_kernel_vs_plain", shape=shape_id,
                 loss_rel_diff=diffs[0], max_grad_rel_diff=max(diffs[1:]))
        del tr
    emit("gnn_zoo", part="breakdown", card=smi,
         **step_breakdown(gin, "ogb_products", dev)[0])
    for arch_id in ("egnn", "mace"):
        arch = get_arch(arch_id)
        for shape_id in ZOO_SHAPES:
            tr, run = trainer_run(arch, shape_id, ZOO_STEPS, dev)
            emit("gnn_zoo", part=arch_id, card=smi, arch=arch_id,
                 shape=shape_id, dtype=arch.model_cfg.dtype,
                 steps=ZOO_STEPS, **run)
            del tr
        emit("gnn_zoo", part="breakdown", card=smi,
             **step_breakdown(arch, "minibatch_lg", dev)[0])
    torch.cuda.synchronize()
    common.reset_launches()
    t0 = time.perf_counter()
    out = quiet(gnn_neighbor_sampling.main, [])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    example = {k: common.LAUNCHES[k] for k in GNN_KERNELS}
    check(all(v > 0 for v in example.values()),
          f"gnn_neighbor_sampling launched {example}")
    check(all(np.isfinite(out["losses"])),
          "a gnn_neighbor_sampling loss is not finite")
    emit("gnn_zoo", part="example", card=smi,
         entry="repro_torch.examples.gnn_neighbor_sampling.main",
         seconds=seconds, launches=example, steps=out["steps"],
         first_loss=out["losses"][0], last_loss=out["losses"][-1],
         rows=out["rows"])
    return dict(rec=chk.rec, runs=runs, example_launches=example)


def step_breakdown(arch, shape_id, dev, reps: int = 3):
    """Where one train step of ``arch`` at ``shape_id`` spends its time:
    the batch, the adjacency (a GNN's, built inside its forward), forward
    and backward (of one microbatch when there are several), clipping and
    the AdamW update, the whole step (host wall ms, each ending in a device
    sync; medians); then one step under torch.profiler: the device's busy
    ms (its events' summed time) and share of the step, and the six
    largest device times by name (none when the profiler sees no device
    events). Returns (that record, (params, opt_state, step, batch))."""
    shape = arch.shape(shape_id)
    init_fn, loss_fn = param_builders(arch, shape)
    params = {k: v.to(dev) for k, v in init_fn(
        torch.Generator().manual_seed(SEED)).items()}
    opt_state = init_opt_state(params, arch.opt)
    step = make_step(arch, shape)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = dict(arch=arch.arch_id, shape=shape_id,
               microbatches=arch.microbatches)
    out["data_ms"] = wall_ms(
        lambda: make_batch(arch, shape, 0, seed=SEED, device=dev), reps)
    batch = make_batch(arch, shape, 0, seed=SEED, device=dev)
    if arch.family == "gnn":
        out["adjacency_ms"] = wall_ms(lambda: build_adjacency(batch), reps)
        mb = batch
    else:
        k = arch.microbatches
        mb = {key: v[:v.shape[0] // k] for key, v in batch.items()}
    fwd, bwd = [], []
    for _ in range(reps + 1):
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _ = loss_fn(leaves, mb)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        got = torch.autograd.grad(loss, list(leaves.values()),
                                  allow_unused=True)
        torch.cuda.synchronize()
        fwd.append((t1 - t0) * 1e3)
        bwd.append((time.perf_counter() - t1) * 1e3)
    out["forward_ms"] = statistics.median(fwd[1:])
    out["backward_ms"] = statistics.median(bwd[1:])
    grads = {k: torch.zeros_like(v) if g is None else g
             for (k, v), g in zip(params.items(), got)}
    out["optimizer_ms"] = wall_ms(lambda: adamw_update(
        params, clip_by_global_norm(grads, arch.opt.grad_clip)[0],
        opt_state, arch.opt), reps)
    del grads, got, leaves, loss
    out["step_ms"] = wall_ms(lambda: step(params, opt_state, batch), reps)
    out["peak_mem_bytes"] = torch.cuda.max_memory_allocated() - base
    prof = profiled(lambda: step(params, opt_state, batch))
    out.update(profiled_step_ms=prof.pop("wall_ms"), **prof)
    return out, (params, opt_state, step, batch)


def peak_of(fn):
    """(fn's result, its wall ms ending in a device sync, the peak bytes it
    allocated over what was allocated before)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (out, (time.perf_counter() - t0) * 1e3,
            torch.cuda.max_memory_allocated() - base)


def run_dien(dev, smi):
    """The dien phase: the Trainer at train_batch, launch.serve's
    serve_recsys at the two serve shapes with the serve step timed alone,
    and the retrieval step."""
    arch = get_arch("dien")
    tr, run = trainer_run(arch, "train_batch", DIEN_STEPS, dev)
    emit("dien", part="train", card=smi, shape="train_batch",
         rows=arch.shape("train_batch").dims["batch"],
         microbatches=arch.microbatches, steps=DIEN_STEPS, **run)
    del tr
    emit("dien", part="breakdown", card=smi,
         **step_breakdown(arch, "train_batch", dev)[0])
    cpu_params = param_builders(arch)[0](torch.Generator().manual_seed(SEED))
    params = {k: v.to(dev) for k, v in cpu_params.items()}
    for shape_id, reps in (("serve_p99", 5), ("serve_bulk", 2)):
        shape = arch.shape(shape_id)
        rows = shape.dims["batch"]
        probs, entry_ms, entry_peak = peak_of(lambda: quiet(
            launch_serve.serve_recsys, arch, rows, SEED))
        check(probs.device.type == "cuda" and probs.shape == (rows,)
              and bool(((probs > 0) & (probs < 1)).all()),
              f"serve_recsys at {shape_id} gave no probabilities")
        del probs
        batch = recsys_batch(arch, shape, 0, SEED, device=dev)
        step = make_step(arch, shape)
        out, _, step_peak = peak_of(lambda: step(params, batch))
        extra = {}
        if shape_id == "serve_p99":
            cpu = step(cpu_params, {k: v.cpu() for k, v in batch.items()})
            extra["max_abs_diff_vs_cpu"] = float((out.cpu() - cpu).abs().max())
            check(extra["max_abs_diff_vs_cpu"] <= 1e-4,
                  f"serve_p99 on the card differs from the CPU: {extra}")
        del out
        emit("dien", part="serve", card=smi, shape=shape_id, rows=rows,
             entry="repro_torch.launch.serve.serve_recsys",
             entry_ms=entry_ms, entry_peak_mem_bytes=entry_peak,
             step_ms=wall_ms(lambda: step(params, batch), reps),
             peak_mem_bytes=step_peak, **extra)
        del batch
    shape = arch.shape("retrieval_cand")
    batch = recsys_batch(arch, shape, 0, SEED, device=dev)
    step = make_step(arch, shape)
    top, _, peak = peak_of(lambda: step(params, batch))
    # the scores again in float64 from the users' final interest
    with torch.inference_mode():
        h_t = dien_user_state(params, batch, arch.model_cfg)[0]
        cand = params["item_table"][batch["candidate_ids"].long()]
        s64 = (h_t.double() @ params["user_proj.w"].double()
               @ cand.double().T)
    check(top.shape == (shape.dims["batch"], 100),
          f"the retrieval step returned {tuple(top.shape)}")
    for row, ids in zip(s64, top):
        rest = row.clone()
        rest[ids] = -INF
        tol = 1e-5 * float(row.abs().max())
        check(ids.unique().numel() == 100
              and float(rest.max()) <= float(row[ids].min()) + tol
              and bool((row[ids].diff() <= tol).all()),
              "the retrieval step's top 100 is not the best 100 in order")
    emit("dien", part="retrieval", card=smi, shape="retrieval_cand",
         candidates=shape.dims["n_candidates"],
         step_ms=wall_ms(lambda: step(params, batch), 5),
         peak_mem_bytes=peak, top1=int(top[0, 0]))


def served(arch, requests, prompt_len, new_tokens, dev):
    """launch.serve.serve_lm at full width with its stats, its peak memory
    over what was allocated before, and its checks: int32 tokens
    [requests, new_tokens] on the GPU, from finite logits."""
    stats = {}
    tokens, wall, peak = peak_of(lambda: quiet(
        launch_serve.serve_lm, arch, requests, prompt_len, new_tokens, SEED,
        dev, stats))
    check(tokens.device.type == "cuda"
          and tuple(tokens.shape) == (requests, new_tokens)
          and tokens.dtype == torch.int32,
          f"serve_lm on {arch.arch_id} returned {tuple(tokens.shape)} "
          f"{tokens.dtype} on {tokens.device}")
    check(stats["logits_finite"],
          f"serve_lm on {arch.arch_id}: a step's logits are not finite")
    return tokens.cpu(), dict(
        entry_ms=wall, prefill_ms=stats["prefill_s"] * 1e3,
        decode_ms_per_token=stats["decode_s"] * 1e3 / max(new_tokens - 1, 1),
        tokens_per_s=requests * new_tokens / stats["seconds"],
        peak_mem_bytes=peak)


@torch.inference_mode()
def lm_consistency(arch, requests, prompt_len, decode_prompt_len, dev):
    """The serve path against lm_forward at full width, on serve_lm's own
    parameters and prompts: the prefill's logits against the forward's last
    row over the prompt; the first decode step's logits (after the prefill
    of the first ``decode_prompt_len`` prompt tokens and its greedy token)
    against the forward's last row over those tokens and that one. Each as
    max |a - b| over max |b|; the prefill within LM_BF16_TOL, a dense
    model's decode step too. Also the prefill and one decode step under
    the profiler (``profiled``).

    An MoE's decode step differs from the forward in two ways that are
    not faults. It routes B tokens, whose capacity (at least 8 an expert)
    never binds, while the forward over B * (decode_prompt_len + 1) tokens
    drops the assignments past an expert's capacity, the last tokens'
    first (they come last in the stable sort). And top-k routing is not
    continuous: bfloat16's rounding noise between two computations can
    swap an expert at the k-th place in some layer. So the MoE decode
    check runs in float32 (parameters and activations) against a forward
    at a capacity factor of E / k, where no assignment drops, within
    LM_F32_DECODE_TOL; the bfloat16 differences are measured beside it,
    not checked."""
    cfg = arch.model_cfg
    params, toks = launch_serve.lm_serve_inputs(arch, requests, prompt_len,
                                                SEED, dev)
    logits_p, cache = lm_prefill(params, toks, cfg)
    del cache
    prof = dict(prefill=profiled(lambda: lm_prefill(params, toks, cfg)))
    full, _ = lm_forward(params, toks, cfg)
    out = dict(prefill_rel_diff=rel_diff(logits_p.float(),
                                         full[:, -1].float()))
    del full
    toks = toks[:, :decode_prompt_len]
    logits_d, seq, cache = first_decode(params, toks, cfg)
    prof["decode_step"] = profiled(lambda: lm_decode_step(
        params, seq[:, -1:], cache, decode_prompt_len, cfg))
    del cache
    if cfg.moe is not None:
        # bfloat16, unchecked: at the config's capacity, and with no drop
        full, _ = lm_forward(params, seq, cfg)
        out["decode_rel_diff_bf16_at_capacity"] = rel_diff(
            logits_d.float(), full[:, -1].float())
        del full
        cfg = no_drop(cfg)
        full, _ = lm_forward(params, seq, cfg)
        out["decode_rel_diff_bf16"] = rel_diff(logits_d.float(),
                                               full[:, -1].float())
        del full
        # checked: float32 activations and parameters, no drop
        cfg = dataclasses.replace(cfg, dtype="float32",
                                  param_dtype="float32")
        params = {k: v.float() for k, v in params.items()}
        logits_d, seq, cache = first_decode(params, toks, cfg)
        del cache
        tol = LM_F32_DECODE_TOL
    else:
        tol = LM_BF16_TOL
    full, _ = lm_forward(params, seq, cfg)
    out.update(decode_prompt_len=decode_prompt_len, decode_dtype=cfg.dtype,
               decode_tolerance=tol,
               decode_rel_diff=rel_diff(logits_d.float(),
                                        full[:, -1].float()))
    check(out["prefill_rel_diff"] <= LM_BF16_TOL
          and out["decode_rel_diff"] <= tol,
          f"{arch.arch_id}: the serve path differs from lm_forward: {out}")
    out["profile"] = prof
    return out


def first_decode(params, toks, cfg):
    """Prefill of ``toks`` into a cache with one free slot, its greedy
    token, and the decode step on it: (its logits, the prompt and that
    token, the cache)."""
    logits_p, cache = lm_prefill(params, toks, cfg,
                                 max_len=toks.shape[1] + 1)
    nxt = torch.argmax(logits_p, -1).to(torch.int32)[:, None]
    logits_d, cache = lm_decode_step(params, nxt, cache, toks.shape[1], cfg)
    return logits_d, torch.cat([toks, nxt], 1), cache


def no_drop(cfg):
    """``cfg`` with an MoE capacity factor of E / k: capacity T an expert,
    so no assignment drops."""
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))


def profiled(fn) -> dict:
    """One call of ``fn`` (its caller has just run the same work: warm)
    under torch.profiler: its wall ms (ending in a device sync), the
    device's busy ms (its own events' summed time: kernels, copies, fills,
    each once) and share of the wall, the device event count, and the six
    largest device times by name (none when the profiler sees no device
    events)."""
    torch.cuda.synchronize()
    # the device's activity alone: a host trace of a prefill's 80,000
    # launches costs the script about a minute to record and fold
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: e.self_device_time_total,
                 reverse=True)[:6]
    return dict(wall_ms=wall, device_busy_ms=busy,
                device_busy_share=busy / wall if busy else None,
                device_events=sum(e.count for e in events),
                top_device_ms=[dict(name=e.key[:80], count=e.count,
                                    ms=e.self_device_time_total / 1e3)
                               for e in top])


def lm_reduced_vs_cpu(arch_id, dev):
    """A reduced LM (float32, TF32 off) on the card against the CPU from
    the same parameters (drawn on the CPU), on lm_batch's batches: the
    prefill step's logits and two decode steps' (the cache grown by 2, the
    prompt's first two tokens decoded),
    each within LM_F32_TOL of the CPU's largest magnitude; the float32
    caches within LM_F32_TOL, the float8 ones by ``fp8_cache_check``; one
    step's gradients within LM_F32_TOL of each CPU tensor's largest
    magnitude, then one make_step train step: loss and grad_norm within
    LM_F32_TOL, each parameter within LM_F32_TOL of its largest magnitude
    where the CPU's first moment shows a gradient above 1e-6 or exactly 0
    (Adam's first update lr * g / (|g| + eps) is fixed there; between,
    within 2 lr)."""
    arch = reduce_arch(arch_id)
    cfg = arch.model_cfg
    init_fn, loss_fn = param_builders(arch)
    cpu = init_fn(torch.Generator().manual_seed(SEED))
    card = {k: v.to(dev) for k, v in cpu.items()}
    out = dict(arch=arch.arch_id, cache_dtype=str(cfg.cache_dtype))
    runs = {}
    for where, params in (("cpu", cpu), ("card", card)):
        d = next(iter(params.values())).device
        pf, dc = arch.shape("prefill_32k"), arch.shape("decode_32k")
        toks = lm_batch(arch, pf, 0, SEED, device=d)["tokens"]
        logits, cache = make_step(arch, pf)(params, {"tokens": toks})
        cache = tuple(torch.cat([c, torch.zeros_like(c[:, :, :2])], 2)
                      for c in cache)
        seq = [logits]
        for i in range(2):
            # the decoded tokens: the prompt's first two, on both devices
            logits, cache = make_step(arch, dc)(params, {
                "token": toks[:, i:i + 1], "cache_k": cache[0],
                "cache_v": cache[1],
                "cache_len": torch.tensor(toks.shape[1] + i,
                                          dtype=torch.int32, device=d)})
            seq.append(logits)
        tr = arch.shape("train_4k")
        batch = lm_batch(arch, tr, 0, SEED, device=d)
        loss, grads = loss_grads(loss_fn, params, batch)
        opt = init_opt_state(params, arch.opt)
        new_p, new_opt, m = make_step(arch, tr)(params, opt, batch)
        runs[where] = dict(logits=[x.cpu() for x in seq],
                           cache=[c.cpu() for c in cache], loss=loss.cpu(),
                           grads=[g.cpu() for g in grads],
                           params={k: v.cpu() for k, v in new_p.items()},
                           opt=new_opt, metrics={k: v.cpu() for k, v in
                                                 m.items()})
    a, b = runs["card"], runs["cpu"]
    out["serve_rel_diff"] = [rel_diff(x, y) for x, y in
                             zip(a["logits"], b["logits"])]
    if cfg.cache_dtype == torch.float8_e4m3fn:
        out.update(fp8_cache_check(arch, card, a["cache"], b["cache"]))
    else:
        out["cache_rel_diff"] = max(rel_diff(x, y) for x, y in
                                    zip(a["cache"], b["cache"]))
    out["grad_rel_diff"] = max(rel_diff(x, y) for x, y in
                               zip(a["grads"], b["grads"]))
    out["loss_rel_diff"] = rel_diff(a["metrics"]["loss"],
                                    b["metrics"]["loss"])
    out["grad_norm_rel_diff"] = rel_diff(a["metrics"]["grad_norm"],
                                         b["metrics"]["grad_norm"])
    worst, loose = 0.0, 0
    for name, want in b["params"].items():
        got = a["params"][name]
        sure = torch.ones_like(want, dtype=torch.bool)
        st = b["opt"]["per_param"][name]
        if "m" in st:
            g = st["m"].abs() / (1 - arch.opt.b1)
            sure = (g > 1e-6) | (g == 0)
        err = (got - want).abs()
        if bool(sure.any()):
            worst = max(worst, float(err[sure].max())
                        / max(float(want.abs().max()), 1e-30))
        check(bool((err[~sure] <= 2 * arch.opt.lr).all()),
              f"{arch.arch_id}: {name} moved more than 2 lr apart")
        loose += int((~sure).sum())
    out.update(param_rel_diff=worst, params_near_zero_gradient=loose)
    check(max(out["serve_rel_diff"] + [out["grad_rel_diff"], worst,
                                       out["loss_rel_diff"],
                                       out["grad_norm_rel_diff"],
                                       out.get("cache_rel_diff", 0.0)])
          <= LM_F32_TOL, f"{arch.arch_id} on the card differs from the CPU: "
                         f"{out}")
    return out


def fp8_cache_check(arch, card, got, want) -> dict:
    """A float8 KV cache on the card (``got``) against the CPU's
    (``want``). The two devices' float32 keys and values differ in their
    last bits, so a value near a float8 rounding midpoint may take the
    adjacent float8 code: every differing byte must be such a neighbour
    (same sign, code one apart). The cast itself is held bit-equal: the
    card's prefill cache equals the card's float32 keys and values (the
    same prefill with a float32 cache) cast on the CPU."""
    bad = 0
    differ = 0
    for x, y in zip(got, want):
        gx = x.view(torch.uint8).to(torch.int32)
        gy = y.view(torch.uint8).to(torch.int32)
        d = gx != gy
        differ += int(d.sum())
        bad += int((d & (((gx - gy).abs() > 1) | ((gx ^ gy) >= 0x80))).sum())
    check(bad == 0, f"{arch.arch_id}: {bad} float8 cache bytes differ "
                    f"between the card and the CPU by more than one code")
    f32 = dataclasses.replace(arch, model_cfg=dataclasses.replace(
        arch.model_cfg, kv_cache_dtype=None))
    pf = arch.shape("prefill_32k")
    toks = lm_batch(arch, pf, 0, SEED,
                    device=next(iter(card.values())).device)["tokens"]
    _, c8 = make_step(arch, pf)(card, {"tokens": toks})
    _, c32 = make_step(f32, pf)(card, {"tokens": toks})
    cast_equal = all(
        torch.equal(x.view(torch.uint8).cpu(),
                    to_float8_e4m3fn(y.cpu()).view(torch.uint8))
        for x, y in zip(c8, c32))
    check(cast_equal, f"{arch.arch_id}: the card's float8 cache is not its "
                      f"float32 keys and values cast as on the CPU")
    return dict(cache_bytes=sum(x.numel() for x in got),
                cache_bytes_adjacent_code=differ, cast_bit_equal=cast_equal)


def lm_kill_resume(dev):
    """qwen3-moe-30b-a3b-reduced on the card: 4 Trainer steps in one run
    against 2, a restore and 2 more; every parameter bit-equal."""
    arch = reduce_arch("qwen3-moe-30b-a3b")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_lm_") as tmp:
        def trainer(steps, sub, every):
            return Trainer(arch, "train_4k", cfg=TrainerConfig(
                steps=steps, ckpt_every=every, log_every=1, seed=SEED,
                ckpt_dir=os.path.join(tmp, sub)))
        a = trainer(4, "a", 100)
        log_a = quiet(a.run)
        quiet(trainer(2, "b", 2).run)
        b = trainer(4, "b", 100)
        log_b = quiet(b.run)
    check(log_b[0]["step"] == 3, "the resumed LM run did not restart at 3")
    exact = all(torch.equal(a.params[k], b.params[k]) for k in a.params)
    check(exact and log_a[-1]["loss"] == log_b[-1]["loss"],
          f"{arch.arch_id}: kill-and-resume on the card is not exact")
    return dict(arch=arch.arch_id, steps=4, final_loss=log_a[-1]["loss"],
                exact=exact)


def fp8_cast_vs_cpu(dev) -> int:
    """to_float8_e4m3fn on the card against the CPU on the same float32
    and bfloat16 values over +-1000 (densely around 448-480): bit-equal.
    Returns the number of values."""
    x = torch.cat([torch.linspace(-1000, 1000, 200001),
                   torch.linspace(440, 490, 50001),
                   -torch.linspace(440, 490, 50001),
                   torch.tensor([464.0, -464.0, INF, -INF, 0.0, -0.0])])
    for dt in (torch.float32, torch.bfloat16):
        got = to_float8_e4m3fn(x.to(dev, dt)).view(torch.uint8).cpu()
        want = to_float8_e4m3fn(x.to(dt)).view(torch.uint8)
        check(torch.equal(got, want),
              f"to_float8_e4m3fn differs between the card and the CPU on "
              f"{dt}")
    return x.numel()


def run_lm(dev, smi):
    """The lm phase: phi4-mini-3.8b and granite-moe-1b-a400m served at full
    width through launch.serve.serve_lm (twice: the same tokens), the
    serve path against lm_forward, the five reduced LMs on the card
    against the CPU and in the Trainer, and one kill-and-resume."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    common.reset_launches()
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 is on for float32 matmuls")
    for arch_id, requests, prompt_len, new_tokens, decode_len in LM_SERVE:
        t1 = time.perf_counter()
        arch = get_arch(arch_id)
        tokens, first = served(arch, requests, prompt_len, new_tokens, dev)
        again, warm = served(arch, requests, prompt_len, new_tokens, dev)
        check(torch.equal(tokens, again),
              f"serve_lm on {arch_id} gave other tokens the second time")
        agree = lm_consistency(arch, requests, prompt_len, decode_len, dev)
        cfg = arch.model_cfg
        emit("lm", part="serve", card=smi, arch=arch_id,
             entry="repro_torch.launch.serve.serve_lm",
             dtype=cfg.dtype, params=cfg.param_count(), requests=requests,
             prompt_len=prompt_len, new_tokens=new_tokens,
             attention="chunked" if prompt_len > ATTN_CHUNK_THRESHOLD
             else "naive", repeat_equal=True, first_run=first, **warm,
             tolerance=LM_BF16_TOL, **agree,
             seconds=time.perf_counter() - t1)
        torch.cuda.empty_cache()
    reduced = []
    for arch_id in LM_ARCHS:
        t1 = time.perf_counter()
        rec = lm_reduced_vs_cpu(arch_id, dev)
        tr, run = trainer_run(reduce_arch(arch_id), "train_4k", LM_STEPS,
                              dev)
        del tr
        rec.update(trainer=dict(steps=LM_STEPS, losses=run["losses"],
                                grad_norms=run["grad_norms"],
                                step_ms=run["step_ms"]))
        emit("lm", part="reduced", card=smi, tolerance=LM_F32_TOL, **rec,
             seconds=time.perf_counter() - t1)
        reduced.append(rec["arch"])
    resume = lm_kill_resume(dev)
    values = fp8_cast_vs_cpu(dev)
    launches = {k: v for k, v in common.LAUNCHES.items() if v}
    check(not launches, f"the LM paths launched port kernels: {launches}")
    emit("lm", part="summary", card=smi, reduced=reduced,
         kill_resume=resume, fp8_cast_bit_equal_values=values,
         kernel_launches=launches, seconds=time.perf_counter() - t0)


def quiet(fn, *args, **kwargs):
    """``fn`` with its printed table dropped: the phase lines carry the
    rows."""
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args, **kwargs)


def spread(values) -> dict:
    med = statistics.median(values)
    return dict(values=values, median=med,
                spread=(max(values) - min(values)) / med if med else 0.0)


def figure_tables(g, args, probe_bfs):
    """Tables 2-4 of the paper's figure scripts on the shared graph, with
    their launches, then their checks."""
    torch.cuda.synchronize()
    common.reset_launches()
    t0 = time.perf_counter()
    t2 = quiet(switching_rows, g, args.scale, EDGEFACTOR, SEED)
    t3 = quiet(maxpos_rows, g, args.scale, EDGEFACTOR, SEED)
    t4 = quiet(counter_rows, g, args.scale, EDGEFACTOR, SEED, MAX_POS)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(common.LAUNCHES)
    check(launches["bottom_up_probe"] > 0 and launches["topdown_scan"] > 0,
          f"Tables 2-4 launched {launches}")

    # Table 2: each layer's direction is the switch rule applied to the
    # previous direction and this layer's counters; v_f sums to the reach
    depth = probe_bfs.depth
    topdown = True
    for r in t2:
        topdown = bool(switch_direction(topdown, r["e_f"], r["v_f"],
                                        r["e_u"], g.n))
        check(r["approach"] == ("top-down" if topdown else "bottom-up"),
              f"Table 2 layer {r['layer']}: {r['approach']} against the "
              f"switch rule")
    reached = int((depth >= 0).sum())
    check(sum(r["v_f"] for r in t2) == reached,
          "Table 2's v_f column does not sum to the vertices reached")
    # Table 3: retired + residue at MAX_POS 8 fit in the unvisited count
    for r in t3:
        unvisited = int(torch.count_nonzero(~bu_entry(depth, r["layer"])[1]))
        retired8 = round(r["retired_frac"][8] * r["found"])
        check(retired8 + r["residue8"] <= unvisited,
              f"Table 3 layer {r['layer']}: retired {retired8} + residue "
              f"{r['residue8']} > unvisited {unvisited}")
    # Table 4: the SIMD and the non-SIMD step find the same vertices and
    # parents on every layer
    for r in t4:
        f, v = bu_entry(depth, r["layer"])
        p = torch.full((g.n,), -1, dtype=torch.int32, device=g.device)
        a = bottomup_simd_step(g, f, v, p, MAX_POS)
        b = bottomup_nosimd_step(g, f, v, p)
        check(torch.equal(a[0], b[0]) and torch.equal(a[2], b[2]),
              f"Table 4 layer {r['layer']}: SIMD and non-SIMD steps differ")
    emit("figures", table="table2", rows=t2, reached=reached)
    emit("figures", table="table3", rows=t3)
    simd = sum(r["t_simd_ms"] for r in t4)
    nosimd = sum(r["t_nosimd_ms"] for r in t4)
    emit("figures", table="table4", rows=t4, t_simd_ms_sum=simd,
         t_nosimd_ms_sum=nosimd, nosimd_over_simd=nosimd / simd,
         simd_time_saved=1.0 - simd / nosimd, seconds=seconds,
         launches=launches, max_pos=MAX_POS,
         timing="best of 3 host wall times, each ending in a device sync")


def figure3(g, args):
    """Fig. 3: harmonic-mean TEPS of each mode at the shared scale and each
    edgefactor, 16 roots, each point timed FIG3_REPEATS times in turns,
    with the launches at each edgefactor."""
    for ef in FIG3_EDGEFACTORS:
        t0 = time.perf_counter()
        scale = args.scale if ef == EDGEFACTOR else min(args.scale,
                                                        FIG3_DENSE_SCALE)
        ge = g if ef == EDGEFACTOR else rmat_graph(scale, ef, SEED)
        torch.cuda.synchronize()
        gen_seconds = time.perf_counter() - t0
        teps = {mode: [] for mode in FIG3_MODES}
        common.reset_launches()
        t0 = time.perf_counter()
        for _ in range(FIG3_REPEATS):
            for mode in FIG3_MODES:
                teps[mode].append(teps_point(ge, scale, ef, mode,
                                             FIG3_ROOTS, SEED))
        seconds = time.perf_counter() - t0
        launches = dict(common.LAUNCHES)
        check(launches["bottom_up_probe"] > 0
              and launches["topdown_scan"] > 0,
              f"Fig. 3 at edgefactor {ef} launched {launches}")
        for mode, values in teps.items():
            check(all(v > 0 for v in values), f"Fig. 3 {mode} ef={ef}: 0 TEPS")
        emit("figures", table="fig3", scale=scale, edgefactor=ef, n=ge.n,
             m=ge.m, roots=FIG3_ROOTS, repeats=FIG3_REPEATS,
             graph_seconds=gen_seconds if ge is not g else 0.0,
             seconds=seconds, launches=launches,
             harmonic_mean_teps={m: spread(v) for m, v in teps.items()})
        del ge


def timed_query(name, fn):
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    m = res.meta
    emit("analytics", query=name, kind=m.kind, seconds=seconds,
         sweeps=m.sweeps, lanes=m.lanes, layers=m.layers,
         truncated=m.truncated, extra={k: v for k, v in m.extra.items()
                                       if not isinstance(v, tuple)})
    return res


def sweep_split(sweep, roots, field: str) -> dict:
    """Seconds of one engine sweep (ending in a device sync) and of the
    host copy of its ``field``: what a query adds on the host is its wall
    time less these."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = sweep(roots)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    getattr(res, field).cpu().numpy()
    return dict(roots=len(roots), sweep=t1 - t0,
                host_copy=time.perf_counter() - t1)


def wire_round_trip(res) -> int:
    """JSON bytes of ``res``; raises unless it decodes to the same bits."""
    wire = json.dumps(result_to_wire(res), sort_keys=True)
    back = result_from_wire(json.loads(wire))
    check(json.dumps(result_to_wire(back), sort_keys=True) == wire,
          f"{type(res).__name__} does not round-trip through the wire")
    check(back.meta == res.meta, f"{type(res).__name__}: meta changed")
    return len(wire)


def scipy_components(g):
    """(count, labels) of ``g``'s connected components by scipy."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components as sp_components
    rp, ci = to_numpy_adj(g)
    a = sp.csr_matrix((np.ones(ci.size, np.int8), ci, rp), shape=(g.n, g.n))
    return sp_components(a, directed=False)


def same_partition(labels, g) -> int:
    """Raises unless ``labels`` induce scipy's partition of ``g``. Returns
    the component count."""
    count, lab = scipy_components(g)
    canon = np.full(count, g.n, np.int64)
    np.minimum.at(canon, lab, np.arange(g.n))   # each component's min id
    check(np.array_equal(canon[lab], labels),
          "component labels differ from scipy's partition")
    return int(count)


def serial_depths(g, sources, rows=None) -> np.ndarray:
    """int32[len(rows), S] depth columns of the serial hybrid bfs (the
    engine the main phase validates), one BFS per source; ``rows`` None
    keeps every vertex."""
    cols = []
    for s in sources:
        d = bfs(g, int(s), "hybrid").depth
        cols.append(d if rows is None else d[rows])
    return torch.stack(cols, dim=1).cpu().numpy()


def independent_checks(g, roots, res) -> dict:
    """The lane engine's answers against the serial bfs and the numpy
    oracle: every khop and bfs depth column, closeness (float64, relative
    CLOSENESS_RTOL) of the top 3 and 5 seeded vertices from the query's
    256 sources, and the diameter bounds from their sources' eccentricities.
    Raises on a difference."""
    want = serial_depths(g, roots)
    check(np.array_equal(res["khop"].depth, want),
          "khop depths differ from the serial bfs")
    check(np.array_equal(res["bfs"].depth, want),
          "bfs_depths differ from the serial bfs")
    rp, ci = to_numpy_adj(g)
    check(np.array_equal(res["bfs"].depth[:, 0],
                         bfs_reference(rp, ci, int(roots[0]))[1]),
          "bfs_depths lane 0 differs from bfs_reference")

    clo = res["closeness"]
    rng = np.random.default_rng(SEED + 3)
    verts = np.unique(np.concatenate([
        [v for v, _ in clo.top(3)], rng.choice(g.n, 5, replace=False)]))
    src = select_sources(g.n, "auto", clo.seed)[0]
    check(src.size == clo.num_sources, "closeness source count differs")
    d = serial_depths(g, src, torch.from_numpy(verts).to(g.device))
    reached = d >= 0
    scale = g.n / src.size
    r_hat = scale * reached.sum(axis=1).astype(np.float64)
    s_hat = scale * np.where(reached, d, 0).sum(axis=1).astype(np.float64)
    ok = (s_hat > 0) & (r_hat > 1)
    want_c = np.zeros(verts.size)
    want_c[ok] = (r_hat[ok] - 1.0) ** 2 / (s_hat[ok] * (g.n - 1))
    got_c = clo.closeness[verts]
    rel = float(np.max(np.abs(got_c - want_c) / np.maximum(want_c, 1e-300)))
    check(rel <= CLOSENESS_RTOL, f"closeness differs from the serial bfs "
          f"sums by {rel} (relative)")

    dia = res["diameter"]
    d = serial_depths(g, dia.sources)
    ecc = [int(d[:, i].max()) for i in range(d.shape[1])
           if d[dia.component, i] >= 0]
    check(bool(ecc) and dia.lower == max(ecc) and dia.upper == 2 * min(ecc),
          f"diameter bounds {dia.lower}, {dia.upper} against the serial "
          f"eccentricities {ecc}")
    return dict(depth_columns=want.shape[1], oracle_columns=1,
                closeness_vertices=verts.tolist(),
                closeness_max_rel_err=rel, closeness_rtol=CLOSENESS_RTOL,
                diameter_sources=len(dia.sources))


def run_analytics(wg, args, sssp_points):
    """The analytics layer on a LaneEngine(lanes=None) over the weighted
    graph, each query timed, with the launches of the unweighted and the
    weighted queries; then components at COMPONENTS_SCALE, the checks, and
    analytics_bench's points (components at COMPONENTS_SCALE)."""
    eng = LaneEngine(wg, lanes=None)
    g = eng.g
    roots = sample_roots(g, KHOP_SOURCES, seed=SEED + 2)
    sources = sample_roots(wg, WEIGHTED_SOURCES, seed=SEED + 1)
    torch.cuda.synchronize()
    common.reset_launches()
    res = dict(
        khop=timed_query("khop_neighborhood k=2", lambda: khop_neighborhood(
            eng, roots, 2)),
        bfs=timed_query("bfs_depths", lambda: bfs_depths(eng, roots)),
        reach=timed_query("reach_hops", lambda: reach_hops(
            eng, roots[:KHOP_SOURCES // 2], roots)),
        closeness=timed_query("closeness_centrality auto", lambda:
                              closeness_centrality(eng, "auto")),
        diameter=timed_query("diameter_bounds", lambda: diameter_bounds(eng)))
    unweighted = dict(common.LAUNCHES)
    common.reset_launches()
    res["sssp"] = timed_query("sssp_distances", lambda: sssp_distances(
        eng, sources))
    res["wcloseness"] = timed_query(
        "weighted_closeness_centrality", lambda:
        weighted_closeness_centrality(eng, sources=WEIGHTED_SOURCES,
                                      seed=SEED))
    weighted = dict(common.LAUNCHES)
    for name in BATCHED_KERNELS:
        check(unweighted[name] > 0,
              f"{name} was not launched by the unweighted queries")
    for name in SSSP_KERNELS:
        check(weighted[name] > 0,
              f"{name} was not launched by the weighted queries")

    scale = min(args.scale, COMPONENTS_SCALE)
    full_count = scipy_components(g)[0]
    cut = (f"scale {scale}, not {args.scale}: connected_components seeds 64 "
           f"roots a sweep and copies the [n, 64] depths to the host each "
           f"sweep; at scale {args.scale} ({full_count} components by "
           f"scipy) that is at least {-(-full_count // 64)} sweeps of "
           f"{4 * 64 * g.n} bytes")
    g_cc = g if scale == args.scale else rmat_graph(scale, EDGEFACTOR, SEED)
    eng_cc = LaneEngine(g_cc, lanes=None)
    common.reset_launches()
    comps = timed_query("connected_components", lambda: connected_components(
        eng_cc))
    cc_launches = dict(common.LAUNCHES)
    res["components"] = comps

    # checks: depth columns, closeness, diameter, components, Dijkstra,
    # the wire
    want = msbfs_pipelined(g, roots, "hybrid", lanes=eng.lanes_for(len(roots)),
                           derive_parents=False).depth.cpu().numpy()
    check(np.array_equal(res["khop"].depth, want),
          "khop depths differ from msbfs_pipelined")
    check(np.array_equal(res["bfs"].depth, want),
          "bfs_depths differ from msbfs_pipelined")
    independent = independent_checks(g, roots, res)
    count = same_partition(comps.labels, g_cc)
    check(count == comps.num_components, "component counts differ")
    err = dijkstra_check(wg, sources, torch.from_numpy(res["sssp"].dist))
    wcloseness = wcloseness_check(eng, wg, res["wcloseness"])
    split = dict(
        khop=sweep_split(eng.sweep, roots, "depth"),
        closeness=sweep_split(eng.sweep, select_sources(g.n, "auto", SEED)[0],
                              "depth"),
        sssp=sweep_split(eng.sssp_sweep, sources, "dist"))
    wire_bytes = {k: wire_round_trip(r) for k, r in res.items()}
    emit("analytics", query="checks", lanes_for_64=eng.lanes_for(64),
         launches_unweighted=unweighted, launches_weighted=weighted,
         launches_components=cc_launches,
         components=dict(scale=scale, cut=cut, n=g_cc.n,
                         full_scale_components=full_count,
                         num_components=comps.num_components,
                         largest=comps.largest, sweeps=comps.sweeps,
                         matches_scipy=True),
         depth_columns_match_msbfs=True, independent=independent,
         dijkstra_lanes=4,
         dijkstra_max_abs_err=err, wcloseness_dijkstra=wcloseness,
         sweep_split=split, wire_bytes=wire_bytes,
         diameter=dict(lower=res["diameter"].lower,
                       upper=res["diameter"].upper),
         closeness_top=res["closeness"].top(3))
    del res, want
    # analytics_bench's points: closeness and khop on this engine, the
    # components point on the cut graph
    points = {name: dict(teps=work / dt, seconds=dt) for name, work, dt in (
        analytics_bench.components_point(eng_cc, scale),
        analytics_bench.closeness_point(eng, args.scale),
        analytics_bench.khop_point(eng, args.scale))}
    del eng_cc, g_cc
    emit("analytics", query="bench", analytics_bench=points,
         components_scale=scale, cut=cut,
         wcloseness={k: v for k, v in sssp_points.items()
                     if k.startswith("wcloseness")})


def timed(obj, name, acc, key, sync=False):
    """Wrap ``obj.name`` so that its seconds add up in ``acc[key]`` (ending
    with a device sync when ``sync``)."""
    fn = getattr(obj, name)

    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        if sync:
            torch.cuda.synchronize()
        acc[key] = acc.get(key, 0.0) + time.perf_counter() - t0
        return out
    setattr(obj, name, wrapper)


def same_answer(rid, got, early, want) -> None:
    """Raises unless the service's answer ``got`` to request ``rid``
    carries ``want``'s result (the offline run_query's): every field of
    their wire but the metadata, which records the service's lanes and
    layers; a khop answer streamed ``early`` holds its lane's depths as
    they stood, so its depth column is compared inside the final band
    (depth <= k) only."""
    early_khop = early and got.meta.kind == "khop"
    skip = {"meta"} | ({"depth"} if early_khop else set())
    a, b = (result_to_wire(r)["fields"] for r in (got, want))
    for key in a:
        if key not in skip:
            check(json.dumps(a[key]) == json.dumps(b[key]),
                  f"{rid} ({got.meta.kind}): {key} differs from run_query's")
    if early_khop:
        def band(d):
            return np.where((d >= 0) & (d <= got.k), d, -1)
        check(np.array_equal(band(got.depth), band(want.depth)),
              f"{rid}: streamed khop band differs")


def http_json(url, payload=None):
    """(status, decoded JSON or text) of one request to the loopback
    HTTP plane; POSTs ``payload`` as JSON when given."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(
        url, method="GET" if payload is None else "POST",
        data=None if payload is None else json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            code, body = r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        code, body = e.code, e.read().decode()
    try:
        return code, json.loads(body)
    except json.JSONDecodeError:
        return code, body


def serve_http(svc, root):
    """The live plane: the worker thread and an ObservabilityServer on
    loopback; health, readiness and metrics, then one khop envelope
    submitted, polled and fetched. Returns (its request, decoded answer,
    round-trip ms, the routes' status codes)."""
    env = AnalyticsRequest(query=KHopQuery(sources=(root,), k=2),
                           id="http-khop", tenant="http")
    codes = {}
    with svc, ObservabilityServer(svc, host="127.0.0.1", port=0) as srv:
        for route in ("/healthz", "/readyz", "/metrics"):
            codes[route], body = http_json(srv.url + route)
        check("service_requests_total" in body,
              "/metrics lacks the request counters")
        t0 = time.perf_counter()
        codes["/v1/submit"], body = http_json(srv.url + "/v1/submit",
                                              env.to_wire())
        check(body.get("status") == "QUEUED", f"/v1/submit: {body}")
        deadline = time.monotonic() + 120
        while http_json(f"{srv.url}/v1/poll/{env.id}")[1]["status"] != DONE:
            check(time.monotonic() < deadline and svc.worker_alive(),
                  f"the HTTP request did not finish: {svc.health()}")
            time.sleep(0.002)
        codes["/v1/result"], wire = http_json(
            f"{srv.url}/v1/result/{env.id}")
        round_trip_ms = (time.perf_counter() - t0) * 1e3
    for route, code in codes.items():
        check(code == 200, f"{route} answered {code}")
    check(not svc.health()["alive"], "the worker outlived stop()")
    return env, AnalyticsAnswer.from_wire(wire), round_trip_ms, codes


def recorder_overhead(fn, check_traces, rounds=2):
    """``fn(recorder)`` unrecorded and recorded in turns: the results must
    be bit-equal and the traces rebuilt from the records must equal the
    result's. Returns the wall ms of each run (ending in a device sync)
    and the records of the last recorded run."""
    ms = {"unrecorded": [], "recorded": []}
    for _ in range(rounds):
        out = {}
        for key, rec in (("unrecorded", None),
                         ("recorded", SweepRecorder(engine="smoke"))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out[key] = fn(rec)
            torch.cuda.synchronize()
            ms[key].append((time.perf_counter() - t0) * 1e3)
        base, got = out["unrecorded"], out["recorded"]
        for name, a, b in zip(base._fields, got, base):
            if a.is_floating_point():
                a, b = a.view(torch.int32), b.view(torch.int32)
            check(torch.equal(a, b),
                  f"recorded sweep: {name} differs from the unrecorded one")
        check_traces(rec, base)
    return dict(ms, overhead_ms=[r - u for r, u in zip(ms["recorded"],
                                                      ms["unrecorded"])],
                layers=rec.num_layers)


def traces_equal(max_trace, names):
    """A ``recorder_overhead`` check: the engine traces ``names`` rebuilt
    from the records equal the result's."""
    def check_traces(rec, res):
        tr = rec.reconstruct_traces(max_trace,
                                    getattr(res, names[0]).shape[1])
        for name in names:
            check(np.array_equal(tr[name], getattr(res, name).cpu().numpy()),
                  f"{name} rebuilt from the records differs")
    return check_traces


def run_serve(wg, args):
    """The serving layer on the weighted graph: replay, HTTP plane, the
    answers against run_query, the recorders, the doctor. Returns the
    launches of the replay and the HTTP request, and the replay's digest
    (``replay_digest``) and wall."""
    g = wg.csr
    out_dir = args.out or tempfile.mkdtemp(prefix="chip_smoke_serve_")
    os.makedirs(out_dir, exist_ok=True)
    flight = os.path.join(out_dir, "serve_flight.jsonl")
    if os.path.exists(flight):
        os.remove(flight)
    tel = Telemetry(record_sweeps=True, flight_path=flight)
    svc = AnalyticsService(wg, ServiceConfig(lanes=0, telemetry=tel,
                                             slo=SERVE_SLO))
    trace = synthetic_trace(g.n, SERVE_REQUESTS, mix=SERVE_MIX,
                            burst=SERVE_BURST, every=SERVE_EVERY, seed=SEED)
    t0 = time.perf_counter()
    svc.warmup()
    warmup_s = time.perf_counter() - t0
    acc = {}
    for pool in (svc._pool("packed"), svc._pool("tropical")):
        timed(pool, "step", acc, "step", sync=True)
    timed(svc._packed, "readout", acc, "readout")
    timed(svc, "_collect_packed", acc, "collect")
    timed(svc, "_collect_tropical", acc, "collect")
    torch.cuda.synchronize()
    common.reset_launches()
    t0 = time.perf_counter()
    stats = svc.replay(trace)
    torch.cuda.synchronize()
    replay_s = time.perf_counter() - t0
    host = dict(digest=replay_digest(svc, trace), wall_s=stats["wall_s"],
                seconds=replay_s)
    replay_layers = stats["layers"]
    # the replay's split: the wrappers go on adding to the dict they hold
    acc = dict(acc)
    env, http_answer, round_trip_ms, codes = serve_http(
        svc, int(sample_roots(g, 1, seed=SEED + 5)[0]))
    torch.cuda.synchronize()
    launches = dict(common.LAUNCHES)
    tel.close()
    for name in SERVE_KERNELS:
        check(launches[name] > 0, f"{name} was not launched by the service")

    # every answer against run_query on an offline engine
    t0 = time.perf_counter()
    eng = LaneEngine(wg)
    check(stats["done"] == SERVE_REQUESTS and stats["rejected"] == 0,
          f"served {stats['done']} of {SERVE_REQUESTS} requests")
    early = {}
    for req in trace:
        rec = svc.record(req.id)
        check(rec.status == DONE, f"{req.id} is {rec.status}")
        same_answer(req.id, rec.answer.result, rec.answered_early,
                    run_query(eng, req.query))
        early[rec.kind] = early.get(rec.kind, 0) + rec.answered_early
    check(early.get("khop", 0) + early.get("reach", 0) > 0,
          "no khop or reach answer streamed before its lane flushed")
    http_rec = svc.record(env.id)
    check(http_answer.result.meta == http_rec.answer.meta,
          "the HTTP answer's meta differs from the service's")
    same_answer(env.id, http_answer.result, http_rec.answered_early,
                run_query(eng, env.query))
    offline_s = time.perf_counter() - t0

    # recorded against unrecorded sweeps, as the engines' entry points run
    roots = sample_roots(g, args.roots, seed=SEED + 1)
    sources = sample_roots(wg, args.sources, seed=SEED + 1)
    overhead = dict(
        msbfs=recorder_overhead(
            lambda rec: msbfs_pipelined(g, roots, "hybrid", lanes=LANES,
                                        derive_parents=False, recorder=rec),
            traces_equal(MAX_TRACE, ("trace_dir", "trace_vf", "trace_ef",
                                     "trace_eu"))),
        sssp=recorder_overhead(
            lambda rec: sssp_pipelined(wg, sources, lanes=SSSP_LANES,
                                       recorder=rec),
            traces_equal(MAX_SSSP_TRACE, ("trace_bucket", "trace_phase"))))

    # the sweep doctor over the flight log
    records = records_from_jsonl(flight)
    reports = diagnose_log(records, n=g.n, alpha=ALPHA_DEFAULT,
                           beta=BETA_DEFAULT)
    findings = {}
    for r in reports:
        for kind, count in r.counts().items():
            findings[kind] = findings.get(kind, 0) + count
    check(findings.get("mis_switch", 0) == 0,
          f"the sweep doctor flags switch decisions: {findings}")
    check(len(records) == sum(len(s.records) for s in tel.sweeps),
          "the flight log lacks recorded layers")

    per_layer = {key: acc.get(key, 0.0) * 1e3 / replay_layers
                 for key in ("step", "readout")}
    per_layer["answer"] = (acc.get("collect", 0.0)
                           - acc.get("readout", 0.0)) * 1e3 / replay_layers
    lanes = svc._packed.lanes
    emit("serve", requests=stats["requests"], done=stats["done"],
         rejected=stats["rejected"], layers=replay_layers,
         wall_s=stats["wall_s"], warmup_s=warmup_s,
         sojourn_layers=stats["sojourn_layers"],
         answered_early=stats["answered_early"], early_by_kind=early,
         mean_lane_occupancy=stats["mean_lane_occupancy"],
         aggregate_mteps=stats["aggregate_mteps"],
         sssp_steps=stats["sssp_steps"], delta=stats["delta"],
         packed_lanes=lanes, packed_slots=svc._packed.slots,
         tropical_lanes=svc._tropical.lanes,
         per_layer_host_ms=per_layer,
         host_s=dict(step=acc.get("step", 0.0),
                     readout=acc.get("readout", 0.0),
                     collect=acc.get("collect", 0.0)),
         readout_bytes_per_layer=4 * g.n * (lanes + svc._packed.slots + 1),
         recorder_overhead=overhead, flight_records=len(records),
         flight_sweeps=len(reports), doctor_findings=findings,
         http=dict(round_trip_ms=round_trip_ms, codes=codes,
                   answered_early=http_rec.answered_early,
                   sojourn=http_rec.sojourn),
         slo=svc.slo.peek(), per_type=stats["per_type"], launches=launches,
         offline_check_s=offline_s, flight_log=flight, replay_s=replay_s,
         replay_digest=host["digest"])
    return launches, host


def replay_digest(svc, trace) -> str:
    """sha256 over every request of a replayed trace, in trace order: its
    RequestRecord's lifecycle fields and its answer's wire JSON, the
    request id aside (ids are drawn from a per-process counter)."""
    h = hashlib.sha256()
    for req in trace:
        rec = svc.record(req.id)
        wire = (None if rec.answer is None
                else rec.answer.to_wire(include_result=True))
        if wire is not None:
            wire.pop("id")
        h.update(json.dumps([
            rec.status, rec.reason, rec.engine,
            None if rec.slots is None else [rec.slots.start, rec.slots.stop],
            rec.submit_layer, rec.dispatch_layer, rec.answer_layer,
            rec.answered_early, rec.sojourn, wire], sort_keys=True).encode())
    return h.hexdigest()


def wcloseness_check(eng, wg, res) -> dict:
    """Weighted closeness against Dijkstra: the query's sources swept
    again at its delta in its one chunk; the closeness of that sweep's
    distances must equal the answer's bit for bit, and its first
    WCLOSENESS_DIJKSTRA_LANES lanes scipy's Dijkstra (dijkstra_check)."""
    t0 = time.perf_counter()
    src = select_sources(eng.n, WEIGHTED_SOURCES, SEED)[0]
    chunk = res.meta.extra["chunk"]
    check(src.size == res.num_sources == chunk,
          f"weighted closeness ran {res.num_sources} sources in chunks of "
          f"{chunk}, not one sweep of {src.size}")
    dist = eng.sssp_sweep(pad_roots(src, chunk),
                          delta=res.meta.extra["delta"]).dist[:, :src.size]
    check(np.array_equal(closeness_from_dists(dist.cpu().numpy(), eng.n),
                         res.closeness),
          "weighted closeness differs from its sources' distances")
    err = dijkstra_check(wg, src, dist, WCLOSENESS_DIJKSTRA_LANES)
    return dict(lanes=WCLOSENESS_DIJKSTRA_LANES, max_abs_err=err,
                seconds=time.perf_counter() - t0)


def run_hillclimb(g, args):
    """A4b: every point of bfs_hillclimb (the B0-B3 ladder, O1, the O2
    MAX_POS and O3 alpha/beta sweeps, O4) on the graph through the serial
    harness, HILLCLIMB_ROOTS roots, HILLCLIMB_REPEATS times in turns;
    harmonic-mean TEPS per point (median and spread), and which O2/O3
    points put the hybrid above pure top-down."""
    points = bfs_hillclimb.points()
    teps = {label: [] for _, _, label, _ in points}
    torch.cuda.synchronize()
    common.reset_launches()
    t0 = time.perf_counter()
    for _ in range(HILLCLIMB_REPEATS):
        for _, _, label, knobs in points:
            teps[label].append(run_graph500(
                args.scale, EDGEFACTOR, num_roots=HILLCLIMB_ROOTS, seed=SEED,
                graph=g, **knobs).harmonic_mean_teps)
    seconds = time.perf_counter() - t0
    launches = dict(common.LAUNCHES)
    check(launches["bottom_up_probe"] > 0 and launches["topdown_scan"] > 0,
          f"the hillclimb launched {launches}")
    for label, values in teps.items():
        check(all(v > 0 for v in values), f"hillclimb {label}: 0 TEPS")
    topdown = statistics.median(teps["B0_topdown"])
    above = [label for label, v in teps.items()
             if label.startswith(("O2", "O3"))
             and statistics.median(v) > topdown]
    emit("hillclimb", scale=args.scale, edgefactor=EDGEFACTOR,
         roots=HILLCLIMB_ROOTS, repeats=HILLCLIMB_REPEATS, seconds=seconds,
         launches=launches,
         harmonic_mean_teps={k: spread(v) for k, v in teps.items()},
         topdown_median_teps=topdown, o2_o3_above_topdown=above,
         hybrid_above_topdown=bool(above))


def run_serve_bench(wg, args):
    """A8b: serve_bench's streamed-against-flushed replay on the weighted
    graph with the serve phase's mix and request count, with its own
    asserts (bit parity of the streamed answers, a khop gain >= 1 layer),
    and the launches of the two replays."""
    torch.cuda.synchronize()
    common.reset_launches()
    t0 = time.perf_counter()
    points = serve_bench.bench_points(args.scale, EDGEFACTOR, SEED,
                                      queries=SERVE_REQUESTS, mix=SERVE_MIX,
                                      graph=wg)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(common.LAUNCHES)
    for name in SERVE_KERNELS:
        check(launches[name] > 0, f"{name} was not launched by serve_bench")
    emit("serve_bench", scale=args.scale, queries=SERVE_REQUESTS,
         mix=SERVE_MIX, points=points, seconds=seconds, launches=launches)


# ---------------------------------------------------------------------------
# serve_dist and examples: the sharded service pools on one NCCL rank, and
# the graph-side examples on the card
# ---------------------------------------------------------------------------


def tick_rows(svc, trace, ticks: int) -> list:
    """The first ``ticks`` scheduler ticks of a service fed the trace's
    first burst: wall ms (ending with a device sync) and host syncs of
    each."""
    svc.warmup()
    for req in trace[:SERVE_BURST]:
        svc.submit(req)
    rows = []
    for _ in range(ticks):
        t0 = time.perf_counter()
        syncs = syncs_of(svc.step)
        torch.cuda.synchronize()
        rows.append(dict(ms=(time.perf_counter() - t0) * 1e3, syncs=syncs))
    return rows


def serve_dist_rank(graph_path, scale, host_digest) -> dict:
    """The serve_dist phase's rank: one NCCL rank on cuda:0, the sharded
    service pools over a 1-rank mesh (the front door with no followers).
    The serve phase's replay (digest against the host replay's), a
    tick's syncs and ms beside the host service's, the compat path
    serve(validate=True) over 32 bfs requests, serve_bench on the sharded
    pools, and one khop over the HTTP plane; each part's launches."""
    from repro_torch.launch.serve_bfs import bfs_requests, serve
    dev = rank_device()
    common.load_library()
    t0 = time.perf_counter()
    wg = load_graph(graph_path, dev)
    g = wg.csr
    out = dict(load_seconds=time.perf_counter() - t0, device=str(dev),
               backend=str(torch.distributed.get_backend()))
    mesh = host_mesh(1)
    trace = synthetic_trace(g.n, SERVE_REQUESTS, mix=SERVE_MIX,
                            burst=SERVE_BURST, every=SERVE_EVERY, seed=SEED)

    def counted(fn):
        torch.cuda.synchronize()
        common.reset_launches()
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t, dict(common.LAUNCHES)

    tel = Telemetry(record_sweeps=True)
    svc = AnalyticsService(wg, ServiceConfig(lanes=0, telemetry=tel,
                                             slo=SERVE_SLO, mesh=mesh))
    check(svc.engine.dg is not None and svc.front_door,
          "the service on a 1-rank mesh is not sharded")

    acc = {}

    def replay(svc):
        svc.warmup()
        # the host time split as the serve phase splits it
        for pool in (svc._pool("packed"), svc._pool("tropical")):
            timed(pool, "step", acc, "step", sync=True)
        timed(svc._packed, "readout", acc, "readout")
        timed(svc, "_collect_packed", acc, "collect")
        timed(svc, "_collect_tropical", acc, "collect")
        stats, seconds, launches = counted(lambda: svc.replay(trace))
        return stats, seconds, launches, replay_digest(svc, trace)
    stats, seconds, launches, dig = svc.lead(replay)
    tel.close()
    check(stats["done"] == SERVE_REQUESTS and stats["rejected"] == 0,
          f"the sharded replay answered {stats['done']} of "
          f"{SERVE_REQUESTS}")
    check(dig == host_digest,
          "the sharded replay's records or answers differ from the host "
          "replay's")
    engines = sorted({rec.engine for rec in tel.sweeps})
    check(engines == ["dist_msbfs", "dist_sssp"],
          f"the sharded pools recorded {engines}")
    out["replay"] = dict(
        seconds=seconds, wall_s=stats["wall_s"], layers=stats["layers"],
        answered_early=stats["answered_early"], sssp_steps=stats["sssp_steps"],
        aggregate_mteps=stats["aggregate_mteps"], launches=launches,
        digest=dig, recorded_sweeps=len(tel.sweeps), recorders=engines,
        host_s=dict(step=acc.get("step", 0.0),
                    readout=acc.get("readout", 0.0),
                    answers=acc.get("collect", 0.0) - acc.get("readout", 0.0)))

    ticks = {}
    for name, where in (("host", {}), ("sharded", dict(mesh=mesh))):
        svc = AnalyticsService(wg, ServiceConfig(lanes=0, **where))
        ticks[name] = svc.lead(lambda svc: tick_rows(svc, trace, SYNC_STEPS))
    out["ticks"] = {name: dict(
        rows=rows, syncs=sorted({r["syncs"] for r in rows}),
        ms_median=statistics.median(r["ms"] for r in rows))
        for name, rows in ticks.items()}

    roots = sample_roots(g, SERVE_DIST_VALIDATED, seed=SEED + 1)
    # the validator's span: serve looks it up when it validates
    import repro_torch.graph.validate as validate
    spans, validate_tree = [], validate.validate_bfs_tree

    def timed_validate(*a):
        t = time.perf_counter()
        out = validate_tree(*a)
        spans.append((t, time.perf_counter()))
        return out
    validate.validate_bfs_tree = timed_validate
    try:
        st, seconds, launches = counted(lambda: serve(
            wg, bfs_requests(roots), 0, SERVE_BURST, SERVE_EVERY,
            validate=True, mesh=mesh))
    finally:
        validate.validate_bfs_tree = validate_tree
    check(st["validated"] and st["requests"] == SERVE_DIST_VALIDATED,
          "the compat path did not validate its trees")
    check(len(spans) == SERVE_DIST_VALIDATED,
          f"the compat path validated {len(spans)} trees")
    out["compat"] = dict(seconds=seconds, launches=launches,
                         layers=st["layers"], lanes=st["lanes"],
                         ndev=st["ndev"], validated=len(spans),
                         replay_wall_s=st["wall_s"],
                         validate_s=max(e for _, e in spans)
                         - min(b for b, _ in spans),
                         validate_tree_s_mean=statistics.mean(
                             e - b for b, e in spans))

    points, seconds, launches = counted(lambda: serve_bench.bench_points(
        scale, EDGEFACTOR, SEED, queries=SERVE_DIST_BENCH_QUERIES,
        mix=SERVE_MIX, graph=wg, mesh=mesh))
    out["bench"] = dict(queries=SERVE_DIST_BENCH_QUERIES, points=points,
                        seconds=seconds, launches=launches)

    svc = AnalyticsService(wg, ServiceConfig(lanes=0, mesh=mesh))
    root = int(sample_roots(g, 1, seed=SEED + 5)[0])

    def live(svc):
        # the trace's first burst replayed first, so /metrics has requests
        svc.warmup()
        svc.replay(trace[:SERVE_BURST])
        return counted(lambda: serve_http(svc, root))
    (env, answer, round_trip_ms, codes), seconds, launches = svc.lead(live)
    same_answer(env.id, answer.result, svc.record(env.id).answered_early,
                run_query(LaneEngine(wg), env.query))
    out["live"] = dict(round_trip_ms=round_trip_ms, codes=codes,
                       seconds=seconds, launches=launches)
    # a one-root khop of depth 2 runs top-down layers only: segment_or
    for part, kernels in (("replay", SERVE_KERNELS), ("compat", BATCHED_KERNELS),
                          ("bench", SERVE_KERNELS), ("live", ("segment_or",))):
        for name in kernels:
            check(out[part]["launches"][name] > 0,
                  f"{name} was not launched by the sharded {part}")
    return out


def run_serve_dist(wg, args, host) -> dict:
    """The serve_dist phase: the sharded service pools in one NCCL rank of
    run_ranks, the weighted graph handed over by file. Returns the
    launches of each part for the kernels line."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_serve_dist_") as tmp:
        path = os.path.join(tmp, "graph.npz")
        save_graph(wg, path)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        out = run_ranks(serve_dist_rank, 1, path, args.scale, host["digest"])
    seconds = time.perf_counter() - t0
    emit("serve_dist", entry="repro_torch.serving.AnalyticsService(mesh=)",
         ranks=1, rank_seconds=seconds, **out,
         host_replay=dict(wall_s=host["wall_s"], seconds=host["seconds"]),
         replay_vs_host=out["replay"]["seconds"] / host["seconds"])
    return {part: out[part]["launches"]
            for part in ("replay", "compat", "bench", "live")}


def run_examples(args) -> dict:
    """The examples phase: the six graph-side examples on the card, through
    their own main (distributed_bfs on one NCCL rank), their printed lines
    kept out of the log; each one's launches (distributed_bfs's rank's
    added), its seconds and what it returned. Returns the phase's
    launches."""
    from repro_torch.examples import (distributed_bfs, graph_analytics,
                                      quickstart, serve_analytics,
                                      sweep_trace, weighted_sssp)
    out_dir = args.out or tempfile.mkdtemp(prefix="chip_smoke_examples_")
    runs = (("quickstart", quickstart, [], SERIAL_KERNELS + BATCHED_KERNELS),
            ("weighted_sssp", weighted_sssp, [], SSSP_KERNELS
             + BATCHED_KERNELS),
            ("graph_analytics", graph_analytics, [], BATCHED_KERNELS),
            ("serve_analytics", serve_analytics, [], SERVE_KERNELS),
            ("sweep_trace", sweep_trace, ["--out-dir", out_dir],
             SERVE_KERNELS),
            ("distributed_bfs", distributed_bfs, ["--ndev", "1"],
             SERIAL_KERNELS))
    total = dict.fromkeys(common.LAUNCHES, 0)
    rows = {}
    for name, module, argv, kernels in runs:
        torch.cuda.synchronize()
        common.reset_launches()
        t0 = time.perf_counter()
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            res = module.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(common.LAUNCHES)
        for k, v in res.pop("rank0_launches", {}).items():
            launches[k] += v
        for k, v in launches.items():
            total[k] += v
        for k in kernels:
            check(launches[k] > 0, f"{k} was not launched by {name}")
        lines = printed.getvalue().splitlines()
        rows[name] = dict(seconds=seconds, launches=launches,
                          printed_lines=len(lines), last_line=lines[-1],
                          returned=res)
    check(rows["distributed_bfs"]["returned"]["match"],
          "distributed_bfs differs from the single-device BFS")
    emit("examples", out_dir=out_dir, launches=total, **rows)
    return total


def digest(*arrays) -> str:
    """sha256 over the arrays' dtypes, shapes and bytes."""
    h = hashlib.sha256()
    for a in arrays:
        a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        h.update(f"{a.dtype.str}{a.shape}".encode())
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def answer_digest(res) -> str:
    """sha256 of an answer's result fields, not its meta: a khop answer by
    its unpacked membership (its words are laid out by the word width)
    and its depth inside the final band (a streamed answer's deeper
    depths are its lane's as they stood)."""
    parts = []
    for f in dataclasses.fields(res):
        v = getattr(res, f.name)
        if f.name == "meta":
            continue
        if isinstance(res, KHopResult) and f.name == "words":
            v = res.member_mask()
        elif isinstance(res, KHopResult) and f.name == "depth":
            v = np.where((v >= 0) & (v <= res.k), v, -1)
        parts.append(v if isinstance(v, np.ndarray) else np.asarray(repr(v)))
    return digest(*parts)


def width_run(wg, args):
    """The u64 phase's work, at this process's word width: the batched
    sweep through run_graph500 at --roots and 4x as many roots (64 lanes)
    with the same roots' msbfs_pipelined results, a 64-source khop (k = 2)
    on LaneEngine(lanes=None), and one streamed replay of the serve
    phase's trace on AnalyticsService(lanes=0). Returns (digests,
    numbers); the results do not depend on the word width, so the
    digests must be the same at 32 and 64 bits."""
    g = wg.csr
    digests = {}
    numbers = dict(word_bits=LANE_WORD_BITS, word_dtype=str(word_dtype()))
    for num in (args.roots, 4 * args.roots):
        res = run_graph500(args.scale, EDGEFACTOR, mode="hybrid",
                           num_roots=num, seed=SEED, graph=g, batched=True,
                           lanes=LANES)
        out = msbfs_pipelined(g, sample_roots(g, num, seed=SEED + 1),
                              "hybrid", lanes=LANES)
        digests[f"sweep_{num}"] = dict(
            {name: digest(getattr(out, name)) for name in
             ("parent", "depth", "num_layers", "edges_traversed")},
            traces=digest(out.trace_dir, out.trace_vf, out.trace_ef,
                          out.trace_eu))
        numbers[f"sweep_{num}"] = dict(
            lanes=res.lanes, sweep_seconds=res.times[0],
            aggregate_teps=res.aggregate_teps)
        del out
    eng = LaneEngine(wg, lanes=None)
    roots = sample_roots(g, KHOP_SOURCES, seed=SEED + 2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    khop = khop_neighborhood(eng, roots, 2)
    numbers["khop"] = dict(seconds=time.perf_counter() - t0,
                           lanes=khop.meta.lanes,
                           words=[str(khop.words.dtype),
                                  list(khop.words.shape)])
    digests["khop_members"] = digest(khop.member_mask())
    del khop

    svc = AnalyticsService(wg, ServiceConfig(lanes=0))
    trace = synthetic_trace(g.n, SERVE_REQUESTS, mix=SERVE_MIX,
                            burst=SERVE_BURST, every=SERVE_EVERY, seed=SEED)
    svc.warmup()
    # the replay's host time split as the serve phase splits it, and the
    # packed layers counted by their read-outs
    acc = {}
    for pool in (svc._pool("packed"), svc._pool("tropical")):
        timed(pool, "step", acc, "step", sync=True)
    timed(svc, "_collect_packed", acc, "collect")
    timed(svc, "_collect_tropical", acc, "collect")
    copy = dict(seconds=0.0, calls=0)
    readout = svc._packed.readout

    def timed_readout():
        t = time.perf_counter()
        out = readout()
        copy["seconds"] += time.perf_counter() - t
        copy["calls"] += 1
        return out
    svc._packed.readout = timed_readout
    stats = svc.replay(trace)
    check(stats["done"] == SERVE_REQUESTS,
          f"the replay answered {stats['done']} of {SERVE_REQUESTS}")
    digests["replay"] = [answer_digest(svc.record(r.id).answer.result)
                         for r in trace]
    lanes = svc._packed.lanes
    numbers["replay"] = dict(
        packed_lanes=lanes, wall_s=stats["wall_s"], layers=stats["layers"],
        answered_early=stats["answered_early"],
        readout_calls=copy["calls"], readout_s=copy["seconds"],
        readout_ms_per_packed_layer=copy["seconds"] * 1e3
        / max(copy["calls"], 1),
        readout_bytes_per_layer=4 * g.n * (lanes + svc._packed.slots + 1),
        host_s=dict(step=acc.get("step", 0.0),
                    answers=acc.get("collect", 0.0) - copy["seconds"]))
    return digests, numbers


def in_turns(fn_a, fn_b, reps, flush):
    """``time_ms`` of two functions in turns (a, b, b, a): two times
    each."""
    a1, b1 = time_ms(fn_a, reps, flush), time_ms(fn_b, reps, flush)
    b2, a2 = time_ms(fn_b, reps, flush), time_ms(fn_a, reps, flush)
    return [a1, a2], [b1, b2]


def u64_kernels(g, reps, flush) -> dict:
    """B3 and both forms of X1 on seeded random int64 words at W = 1, 2, 3
    through the ops wrappers, which hand the kernels the words' int32
    view: each bit-equal to its plain version on that view, and timed in
    turns (int64, int32, int32, int64) beside the same wrapper on the same
    bits as 2W int32 words, as a 32-bit engine would call it. The bound is
    the 32-bit one at 2W planes."""
    n, m, dev = g.n, g.m, g.device
    rec = {name: dict(cases=0, max_abs_err=0, widths={})
           for name in BATCHED_KERNELS}

    def agree(name, label, got, want):
        err = max_abs_err([(got.view(torch.int32), want)])
        check(err == 0 and torch.equal(got.view(torch.int32), want),
              f"{name} on int64 words differs from its plain version on "
              f"the int32 view ({label})")
        rec[name]["cases"] += 1

    for w in U64_WIDTHS:
        fro32, vis32 = random_lanes(n, 2 * w, SEED + 100 + w, dev)
        need32 = ~vis32
        fro, need = fro32.view(torch.int64), need32.view(torch.int64)
        pa = (g.row_ptr[:-1], g.deg, need32, g.col_idx, fro32, MAX_POS)
        acc = msbfs_probe(g.row_ptr, g.col_idx, fro, need, MAX_POS)
        agree("msbfs_probe", f"W={w}", acc, msbfs_probe_ref(*pa))
        found = acc & need
        residue = ((need & ~found) != 0).any(dim=-1) & (g.deg > MAX_POS)
        fb = dict(mask=need, base=found, row_active=residue, min_pos=MAX_POS)
        fb32 = (g.row_ptr, g.col_idx, fro32, need32, None,
                found.view(torch.int32), residue.to(torch.int32), MAX_POS)
        agree("segment_or", f"W={w} fallback", segment_or_rows(
            g.row_ptr, g.col_idx, fro, **fb), segment_or_rows_ref(*fb32))
        sel = torch.full((w,), -1, dtype=torch.int64, device=dev)
        td32 = (g.row_ptr, g.col_idx, fro32, need32, sel.view(torch.int32),
                None, None, 0)
        agree("segment_or", f"W={w} top-down", segment_or_rows(
            g.row_ptr, g.col_idx, fro, need, sel), segment_or_rows_ref(
            *td32))
        torch.cuda.synchronize()
        rows, probes, words = lane_probe_work(pa)
        slots = int(torch.where(residue, (g.deg - MAX_POS).clamp(min=0),
                                0).sum())
        probe_ms, probe_ms_32 = in_turns(
            lambda: msbfs_probe(g.row_ptr, g.col_idx, fro, need, MAX_POS),
            lambda: msbfs_probe(g.row_ptr, g.col_idx, fro32, need32,
                                MAX_POS), reps, flush)
        rec["msbfs_probe"]["widths"][w] = dict(
            ms=probe_ms, ms_32=probe_ms_32,
            bound_ms=lane_probe_cost(n, 2 * w, rows, probes, words)[0],
            planes=2 * w)
        sel32, found32 = sel.view(torch.int32), found.view(torch.int32)
        td_ms, td_ms_32 = in_turns(
            lambda: segment_or_rows(g.row_ptr, g.col_idx, fro, need, sel),
            lambda: segment_or_rows(g.row_ptr, g.col_idx, fro32, need32,
                                    sel32), reps, flush)
        fb_ms, fb_ms_32 = in_turns(
            lambda: segment_or_rows(g.row_ptr, g.col_idx, fro, **fb),
            lambda: segment_or_rows(g.row_ptr, g.col_idx, fro32, need32,
                                    base=found32, row_active=residue,
                                    min_pos=MAX_POS), reps, flush)
        library_ms = x1_library_ms(g, fro, sel, need, w, reps, flush)
        rec["segment_or"]["widths"][w] = dict(
            library_ms=library_ms, topdown_ms=td_ms, topdown_ms_32=td_ms_32,
            topdown_bound_ms=row_or_cost(n, 2 * w, m, False, False, n)[0],
            fallback_ms=fb_ms, fallback_ms_32=fb_ms_32,
            fallback_bound_ms=row_or_cost(n, 2 * w, slots, True, True,
                                          n)[0],
            fallback_rows=int(residue.sum()), fallback_slots=slots,
            planes=2 * w)
    return rec


def x1_library_ms(g, fro, sel, need, w, reps, flush) -> float:
    """X1's library yardstick on int64 words, as lane_kernel_random times
    it on int32 words: one segment_reduce(max) over the edge slots'
    frontier words unpacked to 64W float32 bit columns (built outside the
    timing, in chunks of slots), held against the kernel's top-down form
    with every row unmasked and every lane selected."""
    m, bits = g.m, LANE_WORD_BITS * w
    cols = torch.empty((m, bits), dtype=torch.float32, device=g.device)
    chunk = 1 << 22
    for lo in range(0, m, chunk):
        cols[lo:lo + chunk] = unpack_lanes(fro[g.col_idx[lo:lo + chunk]],
                                           bits)
    lengths = g.deg.to(torch.int64)

    def library():
        return torch.segment_reduce(cols, "max", lengths=lengths, axis=0,
                                    unsafe=True, initial=0.0)

    full = torch.full_like(need, -1)
    check(torch.equal(library().to(torch.bool), unpack_lanes(
        segment_or_rows(g.row_ptr, g.col_idx, fro, full, sel), bits)),
          f"X1's library yardstick at W={w} computes another function")
    ms = time_ms(library, reps, flush)
    del cols
    torch.cuda.empty_cache()
    return ms


def u64_child(args, dev) -> int:
    """The u64 phase's child, run with LANE_WORD_BITS=64: the kernels on
    int64 words, then width_run with the launches of that run alone.
    Prints its phase lines and, last, one "u64_ok" line."""
    check(LANE_WORD_BITS == 64 and word_dtype() == torch.int64,
          f"the u64 child runs at {LANE_WORD_BITS}-bit words")
    t0 = time.perf_counter()
    common.load_library()
    wg = rmat_weighted_graph(args.scale, EDGEFACTOR, seed=SEED)
    g = wg.csr
    torch.cuda.synchronize()
    emit("u64_graph", word_bits=LANE_WORD_BITS, n=g.n, m=g.m,
         seconds=time.perf_counter() - t0, build_cached=common.build_info.get(
             "cached"))
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=dev)
    kernels = u64_kernels(g, args.reps, flush)
    del flush
    emit("u64_kernel", **kernels)
    torch.cuda.synchronize()
    common.reset_launches()
    digests, numbers = width_run(wg, args)
    torch.cuda.synchronize()
    launches = dict(common.LAUNCHES)
    for name in BATCHED_KERNELS:
        check(launches[name] > 0,
              f"{name} was not launched at 64-bit words")
    # the sharded engine on a 1-rank NCCL mesh, at 64-bit words: the host
    # sweep's digests
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_u64_") as tmp:
        path = os.path.join(tmp, "graph.npz")
        save_graph(g, path)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        dist = run_ranks(dist_sweep_rank, 1, path, args.roots)
    check(dist["word_bits"] == 64, "the sharded rank ran at other words")
    for engine in ("dist", "dist2d"):
        check(dist[engine]["digests"] == digests[f"sweep_{args.roots}"],
              f"the {engine} sweep at 64-bit words differs from the host "
              f"sweep")
        for name in BATCHED_KERNELS:
            check(dist[engine]["launches"][name] > 0,
                  f"{name} was not launched by the {engine} sweep at 64 "
                  f"bits")
    numbers["dist_sweep"] = dict(roots=args.roots, lanes=LANES,
                                 seconds=time.perf_counter() - t0,
                                 engines=["dist", "dist2d (1x1, compressed)"],
                                 digests_equal=sorted(dist["dist"]["digests"]))
    emit("u64_ok", word_bits=LANE_WORD_BITS, launches=launches,
         dist_launches=dist["dist"]["launches"],
         dist2d_launches=dist["dist2d"]["launches"], numbers=numbers,
         digests=digests,
         kernels={name: dict(cases=r["cases"], max_abs_err=r["max_abs_err"])
                  for name, r in kernels.items()},
         kernel_widths={name: r["widths"] for name, r in kernels.items()})
    return 0


def run_u64(wg, args) -> dict:
    """The u64 phase: width_run here at 32-bit words, then this script
    again in a child with LANE_WORD_BITS=64 (--u64-child), whose lines are
    relayed. Fails unless the child exits 0 with a u64_ok line whose
    digests equal this run's. Returns the child's u64_ok record."""
    torch.cuda.synchronize()
    common.reset_launches()
    digests, numbers = width_run(wg, args)
    torch.cuda.synchronize()
    launches = dict(common.LAUNCHES)
    torch.cuda.empty_cache()
    cmd = [sys.executable, os.path.abspath(__file__), "--u64-child",
           "--scale", str(args.scale), "--roots", str(args.roots),
           "--reps", str(args.reps)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, env=dict(os.environ, LANE_WORD_BITS="64"),
                          capture_output=True, text=True,
                          timeout=U64_CHILD_TIMEOUT)
    child_s = time.perf_counter() - t0
    child = None
    for line in proc.stdout.splitlines():
        print(line, flush=True)
        if line.startswith('{"phase": "u64_ok"'):
            child = json.loads(line)
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr[-8000:])
    check(proc.returncode == 0, f"the u64 child exited {proc.returncode}")
    check(child is not None, "the u64 child printed no u64_ok line")
    for key, want in digests.items():
        check(child["digests"][key] == want,
              f"{key} at 64-bit words differs from the 32-bit run")
    emit("u64", child_seconds=child_s, digests_equal=sorted(digests),
         replay_answers=len(digests["replay"]), launches_32=launches,
         launches_64=child["launches"], numbers_32=numbers,
         numbers_64=child["numbers"])
    return child


# ---------------------------------------------------------------------------
# dist: the 1-D distributed engines
# ---------------------------------------------------------------------------


def sweep_layer_state(g, roots):
    """The host engine's state at the layer of a 64-lane sweep with the
    most bottom-up lanes: (layer, frontier [n, W], visited [n, W], bu_sel,
    td_sel) on the card, the selectors as W words (td_sel all lanes when
    that layer has no top-down lane, so the top-down form has work)."""
    s = msbfs_engine_enqueue(msbfs_engine_init(g, len(roots), LANES), roots)
    best = None
    while not msbfs_engine_idle(s):
        s = _refill(g, s, True)
        topdown, live = _plan(s, "hybrid", g.n, ALPHA_DEFAULT, BETA_DEFAULT)
        bu = ~topdown & live
        if best is None or bu.sum() > best[0]:
            best = (int(bu.sum()), s.sweep_layers, s.frontier.clone(),
                    s.visited.clone(),
                    torch.from_numpy(pack_lanes_np(bu)).to(g.device),
                    torch.from_numpy(pack_lanes_np(topdown & live)).to(
                        g.device))
        s = msbfs_engine_step(g, s)
    layer, fro, vis, bu_sel, td_sel = best[1:]
    if not bool((td_sel != 0).any()):
        td_sel = torch.full_like(td_sel, -1)
    return layer, fro, vis, bu_sel, td_sel


def dist_kernels(g, probe_out, lane_state, reps, flush):
    """The dist phase's kernels on the card, no process group needed: B1
    on every bottom-up layer of the probe root's BFS, and B3 and both forms
    of X1 on the 64-lane sweep layer with the most bottom-up lanes
    (``lane_state``, ``sweep_layer_state``'s), each on every row block of
    partition_graph(g, 4) against the global frontier (as a rank of a
    4-rank engine calls it), bit-equal to its plain version, timed beside
    the same kernel on the whole graph."""
    dev = g.device
    dg = partition_graph(g, DIST_BLOCKS)
    blocks = [dg.local(d, dev) for d in range(DIST_BLOCKS)]
    rec = {name: dict(cases=0, max_abs_err=0) for name in DIST_KERNELS}
    dirs = probe_out.trace_dir.tolist()
    b1 = []
    for layer, f, v, p in layer_states(g, probe_out):
        if dirs[layer] != 1:
            continue
        fw, unv = bitmap.pack(f), ~v
        row = dict(layer=layer, whole_ms=time_ms(
            lambda: bottom_up_probe_cuda(g.row_ptr, unv, p, g.col_idx, fw,
                                         MAX_POS), reps, flush),
            block_ms=[])
        for blk in blocks:
            rows = slice(blk.base, blk.base + dg.n_loc)
            bu, bp = unv[rows].contiguous(), p[rows].contiguous()
            bg = blk.g
            k = bottom_up_probe_cuda(bg.row_ptr, bu, bp, bg.col_idx, fw,
                                     MAX_POS)
            want = bottom_up_probe_ref(bg.row_ptr[:-1], blk.deg,
                                       bu.to(torch.int32), bp, bg.col_idx,
                                       fw, MAX_POS)
            err = max_abs_err(zip(k, want))
            check(err == 0 and all(torch.equal(a, b) for a, b in
                                   zip(k, want)),
                  f"bottom_up_probe differs from its plain version on block "
                  f"{blk.base // dg.n_loc} of layer {layer}")
            rec["bottom_up_probe"]["cases"] += 1
            row["block_ms"].append(time_ms(
                lambda: bottom_up_probe_cuda(bg.row_ptr, bu, bp, bg.col_idx,
                                             fw, MAX_POS), reps, flush))
        b1.append(row)
    rec["bottom_up_probe"]["layers"] = b1

    layer, fro, vis, bu_sel, td_sel = lane_state
    chk = LaneKernelCheck(g)
    ka, _, fa = chk.bottomup("dist whole graph", fro, ~vis & bu_sel)
    ta = chk.topdown("dist whole graph", fro, vis, td_sel)
    lane = dict(layer=layer, bu_lanes=int(unpack_lanes(bu_sel, LANES).sum()),
                whole_ms=dict(
                    probe=time_ms(lambda: msbfs_probe_cuda(*ka), reps, flush),
                    fallback=time_ms(lambda: segment_or_rows_cuda(*fa), reps,
                                     flush),
                    topdown=time_ms(lambda: segment_or_rows_cuda(*ta), reps,
                                    flush)),
                block_ms=dict(probe=[], fallback=[], topdown=[]))
    checks = [chk]
    for blk in blocks:
        rows = slice(blk.base, blk.base + dg.n_loc)
        bchk = LaneKernelCheck(blk.g)
        bvis = vis[rows].contiguous()
        label = f"dist block {blk.base // dg.n_loc}"
        ka, _, fa = bchk.bottomup(label, fro, ~bvis & bu_sel)
        ta = bchk.topdown(label, fro, bvis, td_sel)
        for form, fn, a in (("probe", msbfs_probe_cuda, ka),
                            ("fallback", segment_or_rows_cuda, fa),
                            ("topdown", segment_or_rows_cuda, ta)):
            lane["block_ms"][form].append(time_ms(lambda: fn(*a), reps,
                                                  flush))
        checks.append(bchk)
    for c in checks:
        for name in ("msbfs_probe", "segment_or"):
            rec[name]["cases"] += c.rec[name]["cases"]
            rec[name]["max_abs_err"] = max(rec[name]["max_abs_err"],
                                           c.rec[name]["max_abs_err"])
    rec["msbfs_probe"]["sweep_layer"] = lane
    rec["segment_or"]["sweep_layer"] = lane
    emit("dist_kernel", blocks=DIST_BLOCKS, n_loc=dg.n_loc, m_loc=dg.m_loc,
         block_slots=[int(b.g.row_ptr[-1]) for b in blocks],
         probe_root_bottomup_layers=b1, sweep_layer=lane,
         cases={k: r["cases"] for k, r in rec.items()})
    return rec


def sweep_digests(out) -> dict:
    """sha256 of every MSBFSResult field, as width_run takes them."""
    return dict({name: digest(getattr(out, name)) for name in
                 ("parent", "depth", "num_layers", "edges_traversed")},
                traces=digest(out.trace_dir, out.trace_vf, out.trace_ef,
                              out.trace_eu))


def dist_sweep_rank(graph_path, num) -> dict:
    """One NCCL rank of the u64 child: one sweep of ``num`` roots in 64
    lanes on the sharded engine over a 1-rank mesh, then on the 2-D engine
    over a 1x1 grid with compressed exchanges, each with the launches of
    that sweep alone and its digests."""
    from repro_torch.core.dist2d import dist2d_msbfs
    dev = rank_device()
    common.load_library()
    g = load_graph(graph_path, dev)
    roots = sample_roots(g, num, seed=SEED + 1)
    out = dict(word_bits=LANE_WORD_BITS)
    for name, run in (
            ("dist", lambda: dist_msbfs(partition_graph(g, 1), roots,
                                        host_mesh(1), "hybrid",
                                        lanes=LANES)),
            ("dist2d", lambda: dist2d_msbfs(partition_graph_2d(g, 1, 1),
                                            roots, mesh2d(1, 1), "hybrid",
                                            lanes=LANES, compress=True))):
        torch.cuda.synchronize()
        common.reset_launches()
        res = run()
        torch.cuda.synchronize()
        out[name] = dict(launches=dict(common.LAUNCHES),
                         digests=sweep_digests(res))
    return out


def dist_rank(graph_path, scale, num, reps) -> dict:
    """The dist phase's rank: one NCCL rank on cuda:0. dist_bfs for Fig.
    3's 16 roots against the serial bfs; run_graph500(batched=True,
    mesh=...) at ``num`` and 4x ``num`` roots in 64 lanes, every result
    field's digest against the host engine's; the sharded and the host
    harness timed in turns, and the sweep split into the engine's steps
    and the result; one sweep step by step (wall, host syncs, the two
    collectives); LaneEngine(mesh=) against LaneEngine(). Each path's
    launches are counted over its run alone."""
    dev = rank_device()
    common.load_library()
    t0 = time.perf_counter()
    g = load_graph(graph_path, dev)
    out = dict(load_seconds=time.perf_counter() - t0, device=str(dev),
               backend=str(torch.distributed.get_backend()))
    mesh = host_mesh(1)
    dg = partition_graph(g, 1)

    roots = sample_roots(g, FIG3_ROOTS, seed=SEED + 1)
    dist_bfs(dg, int(roots[0]), mesh)               # warm-up
    torch.cuda.synchronize()
    common.reset_launches()
    got, dist_ms = [], []
    for r in roots:
        t = time.perf_counter()
        got.append(dist_bfs(dg, int(r), mesh))
        torch.cuda.synchronize()
        dist_ms.append((time.perf_counter() - t) * 1e3)
    out["bfs_launches"] = dict(common.LAUNCHES)
    serial_ms = []
    for r, res in zip(roots, got):
        t = time.perf_counter()
        want = bfs(g, int(r), "hybrid")
        torch.cuda.synchronize()
        serial_ms.append((time.perf_counter() - t) * 1e3)
        check(torch.equal(res.parent, want.parent)
              and torch.equal(res.depth, want.depth)
              and int(res.num_layers) == int(want.num_layers),
              f"dist_bfs differs from the serial bfs at root {int(r)}")
    del got
    out["bfs"] = dict(roots=len(roots), dist_ms=dist_ms, serial_ms=serial_ms,
                      dist_ms_median=statistics.median(dist_ms),
                      serial_ms_median=statistics.median(serial_ms))

    for count in (num, 4 * num):
        torch.cuda.synchronize()
        common.reset_launches()
        res = run_graph500(scale, EDGEFACTOR, mode="hybrid",
                           num_roots=count, seed=SEED, graph=g, batched=True,
                           lanes=LANES, mesh=mesh)
        torch.cuda.synchronize()
        launches = dict(common.LAUNCHES)
        rts = sample_roots(g, count, seed=SEED + 1)
        want = sweep_digests(msbfs_pipelined(g, rts, "hybrid", lanes=LANES))
        have = sweep_digests(dist_msbfs(dg, rts, mesh, "hybrid",
                                        lanes=LANES))
        check(have == want, f"the sharded sweep of {count} roots differs "
                            f"from the host engine: {have} {want}")
        out[f"sweep_{count}"] = dict(
            launches=launches, ndev=res.ndev, lanes=res.lanes,
            sweep_seconds=res.times[0], aggregate_teps=res.aggregate_teps,
            digests_equal=sorted(want))

    # the analytics engine on the mesh: the same depths as on the card
    rts = sample_roots(g, num, seed=SEED + 1)
    want = LaneEngine(g, lanes=LANES).sweep(rts).depth
    check(torch.equal(LaneEngine(g, mesh=mesh, lanes=LANES).sweep(rts).depth,
                      want), "LaneEngine(mesh=) differs from LaneEngine()")
    out["lane_engine_roots"] = num
    del want
    # the turns start from an empty allocator cache: the 4x sweeps above
    # leave it holding their GB-sized blocks
    torch.cuda.empty_cache()
    turns = {"host": [], "dist": []}
    for i in range(DIST_TURNS):
        for who in (("host", "dist") if i % 2 == 0 else ("dist", "host")):
            res = run_graph500(scale, EDGEFACTOR, mode="hybrid",
                               num_roots=num, seed=SEED, graph=g,
                               batched=True, lanes=LANES, warmup=False,
                               mesh=mesh if who == "dist" else None)
            turns[who].append(dict(seconds=res.times[0],
                                   aggregate_teps=res.aggregate_teps))
    out["turns"] = turns

    # the same sweep split into the engine's steps and the result (the
    # parent derivation), each engine in turns
    rts = sample_roots(g, num, seed=SEED + 1)
    engines = dict(
        host=(lambda: msbfs_engine_enqueue(msbfs_engine_init(
                  g, len(rts), LANES), rts),
              lambda st: msbfs_engine_drain(g, st),
              lambda st: msbfs_engine_result(g, st)),
        dist=(lambda: dist_msbfs_engine_enqueue(dist_msbfs_engine_init(
                  dg, mesh, len(rts), LANES), rts),
              lambda st: dist_msbfs_engine_drain(dg, st, mesh),
              lambda st: dist_msbfs_engine_result(dg, st, mesh)))
    split = {"host": [], "dist": []}
    for i in range(DIST_TURNS):
        for who in (("host", "dist") if i % 2 == 0 else ("dist", "host")):
            init, drain, result = engines[who]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st = drain(init())
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            result(st)
            torch.cuda.synchronize()
            split[who].append(dict(steps_ms=(t1 - t0) * 1e3,
                                   result_ms=(time.perf_counter() - t1) * 1e3))
            del st
    out["split"] = split

    s = dist_msbfs_engine_enqueue(
        dist_msbfs_engine_init(dg, mesh, len(rts), LANES), rts)
    steps = []
    while not dist_msbfs_engine_idle(s):
        steps.append(dict(
            layer=s.sweep_layers,
            syncs=syncs_of(lambda: dist_msbfs_engine_step(dg, s, mesh)),
            step_ms=wall_ms(lambda: dist_msbfs_engine_step(dg, s, mesh),
                            reps)))
        s = dist_msbfs_engine_step(dg, s, mesh)
    own = s.frontier[:s.visited.shape[0]]       # a [n_loc, W] row block
    counters = torch.zeros((3, LANES), dtype=torch.int32, device=dev)
    exchange_ms = wall_ms(lambda: all_gather(own, s.comm), reps)
    counters_ms = wall_ms(lambda: psum(counters, s.comm).cpu(), reps)
    step_ms = statistics.median(r["step_ms"] for r in steps)
    out["step"] = dict(
        rows=steps, step_ms_median=step_ms, exchange_ms=exchange_ms,
        counters_allreduce_readback_ms=counters_ms,
        compute_ms=step_ms - exchange_ms - counters_ms,
        syncs_per_step=sorted({r["syncs"] for r in steps}),
        gathered_bytes=s.comm.size * own.numel() * own.element_size())
    return out


def run_dist(g, args, probe_out, lane_state) -> dict:
    """The dist phase: the kernels on the blocks of a 4-way partition here,
    then the 1-rank NCCL path in a rank of run_ranks, the graph handed over
    by file. Returns the record the kernels line takes."""
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=g.device)
    rec = dist_kernels(g, probe_out, lane_state, max(args.reps // 4, 3),
                       flush)
    del flush
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dist_") as tmp:
        path = os.path.join(tmp, "graph.npz")
        save_graph(g, path)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        out = run_ranks(dist_rank, 1, path, args.scale, args.roots,
                        max(args.reps // 4, 3))
    seconds = time.perf_counter() - t0
    check(out["bfs_launches"]["bottom_up_probe"] > 0,
          "bottom_up_probe was not launched by dist_bfs")
    for count in (args.roots, 4 * args.roots):
        for name in BATCHED_KERNELS:
            check(out[f"sweep_{count}"]["launches"][name] > 0,
                  f"{name} was not launched by the sharded sweep")
    check(out["step"]["syncs_per_step"] == [1],
          f"a sharded step makes {out['step']['syncs_per_step']} host syncs")
    turns = out["turns"]
    emit("dist", entry="repro_torch.graph.graph500.run_graph500(mesh=)",
         ranks=1, rank_seconds=seconds, **out,
         host_sweep_seconds_median=statistics.median(
             t["seconds"] for t in turns["host"]),
         dist_sweep_seconds_median=statistics.median(
             t["seconds"] for t in turns["dist"]),
         split_ms_median={who: {k: statistics.median(r[k] for r in rows)
                                for k in ("steps_ms", "result_ms")}
                          for who, rows in out["split"].items()})
    rec["bottom_up_probe"]["launches"] = out["bfs_launches"]["bottom_up_probe"]
    for name in BATCHED_KERNELS:
        rec[name]["launches"] = {
            f"sweep_{c}": out[f"sweep_{c}"]["launches"][name]
            for c in (args.roots, 4 * args.roots)}
    return rec


# ---------------------------------------------------------------------------
# dist2d and dist_sssp: the 2-D grid engine and the distributed SSSP engines
# ---------------------------------------------------------------------------


def rows_of(t, n, fill=0):
    """``t`` [rows, ...] padded with ``fill`` to ``n`` rows."""
    if t.shape[0] == n:
        return t
    out = t.new_full((n,) + tuple(t.shape[1:]), fill)
    out[:t.shape[0]] = t
    return out


def column_slice(t, dg, j):
    """Column block ``j``'s rows of a global [n, ...] array: its chunk of
    every row block, in grid-row order (a 2-D step's x_j)."""
    c = dg.chunk
    return torch.cat([t[(i * dg.pc + j) * c:(i * dg.pc + j + 1) * c]
                      for i in range(dg.pr)])


def grid_lane_kernels(g, lane_state, reps, flush):
    """B3 and both forms of X1 on every block (i, j) of partition_graph_2d
    at GRID, on the 64-lane sweep layer with the most bottom-up lanes:
    the block's rows against the column block's frontier slice x_j,
    assembled from the global frontier (as rank (i, j) of a 2x2 engine
    calls them), bit-equal to the plain versions and timed beside the whole
    graph; then bit-equal (untimed) on every block of the GRID_CHECKS
    grids, where x_j has fewer (1x4) or more (4x1) rows than the block."""
    dev = g.device
    layer, fro, vis, bu_sel, td_sel = lane_state
    chk = LaneKernelCheck(g)
    ka, _, fa = chk.bottomup("dist2d whole graph", fro, ~vis & bu_sel)
    ta = chk.topdown("dist2d whole graph", fro, vis, td_sel)
    lane = dict(layer=layer, grid=GRID, checked_grids=GRID_CHECKS,
                bu_lanes=int(unpack_lanes(bu_sel, LANES).sum()),
                whole_ms=dict(
                    probe=time_ms(lambda: msbfs_probe_cuda(*ka), reps, flush),
                    fallback=time_ms(lambda: segment_or_rows_cuda(*fa), reps,
                                     flush),
                    topdown=time_ms(lambda: segment_or_rows_cuda(*ta), reps,
                                    flush)),
                blocks=[], block_ms=dict(probe=[], fallback=[], topdown=[]))
    checks = [chk]
    for pr, pc in (GRID,) + GRID_CHECKS:
        dg = partition_graph_2d(g, pr, pc)
        f, v = rows_of(fro, dg.n), rows_of(vis, dg.n)
        for d in range(pr * pc):
            i, j = divmod(d, pc)
            bg = dg.local(d, dev).g
            x = column_slice(f, dg, j)
            rows = v[i * dg.n_loc_r:(i + 1) * dg.n_loc_r]
            bchk = LaneKernelCheck(bg)
            label = f"dist2d {pr}x{pc} block ({i}, {j})"
            ka, _, fa = bchk.bottomup(label, x, ~rows & bu_sel)
            ta = bchk.topdown(label, x, rows, td_sel)
            checks.append(bchk)
            if (pr, pc) != GRID:
                continue
            lane["blocks"].append(dict(block=(i, j), rows=dg.n_loc_r,
                                       x_rows=dg.n_x,
                                       slots=int(bg.row_ptr[-1])))
            for form, fn, a in (("probe", msbfs_probe_cuda, ka),
                                ("fallback", segment_or_rows_cuda, fa),
                                ("topdown", segment_or_rows_cuda, ta)):
                lane["block_ms"][form].append(time_ms(lambda: fn(*a), reps,
                                                      flush))
        del dg, f, v
    rec = {name: dict(cases=sum(c.rec[name]["cases"] for c in checks),
                      max_abs_err=max(c.rec[name]["max_abs_err"]
                                      for c in checks), sweep_layer=lane)
           for name in BATCHED_KERNELS}
    emit("dist2d_kernel", sweep_layer=lane,
         cases={name: r["cases"] for name, r in rec.items()})
    return rec


def both_phase_step(wg, sources, delta):
    """The host SSSP engine, ``sources`` in SSSP_LANES lanes, stepped to the
    first step with lanes in both phases: (step, {phase: (weights,
    values)}), the step's phase inputs."""
    roots = sample_roots(wg, sources, seed=SEED + 1)
    s = sssp_engine_enqueue(sssp_engine_init(wg, len(roots), SSSP_LANES),
                            roots)
    while not sssp_engine_idle(s):
        s = prepare_step(wg, s, delta)
        p = plan_step(wg, s, delta)
        if p.iterating.any() and p.settling.any():
            return s.sweep_steps, {phase: (w, vals) for phase, w, vals in
                                   phase_inputs(wg, s, delta, p)}
        s = sssp_engine_step(wg, s, delta)
    raise SmokeFailure("no SSSP step has lanes in both phases")


def grid_relax_kernels(wg, sources, reps, flush):
    """B4 and X2 on the light and the heavy input of an SSSP sweep step
    with both phases live, on every block of partition_weighted_graph(wg,
    4) (against the replicated values, as a 1-D rank relaxes) and of
    partition_weighted_graph_2d at GRID (against the column block's slice
    of the values), bit-equal to their plain versions and timed beside the
    whole graph."""
    dev = wg.device
    delta = default_delta(wg)
    step, inputs = both_phase_step(wg, sources, delta)
    out = dict(step=step, delta=delta, sources={
        phase: int(torch.isfinite(vals).sum())
        for phase, (_, vals) in inputs.items()}, whole_ms={})

    def relax_ms(c, label, w, vals):
        ra, fa = c.relax(label, w, vals)
        return dict(probe=time_ms(lambda: semiring_relax_cuda(*ra), reps,
                                  flush),
                    fold=time_ms(lambda: relax_fallback_cuda(*fa), reps,
                                 flush))

    chk = RelaxKernelCheck(wg)
    for phase, (w, vals) in inputs.items():
        out["whole_ms"][phase] = relax_ms(chk, f"dist_sssp whole {phase}", w,
                                          vals)
    checks = [chk]
    for kind in ("1d", "2d"):
        if kind == "1d":
            dwg, blocks = partition_weighted_graph(wg, DIST_BLOCKS), None
            nblocks = DIST_BLOCKS
        else:
            dwg = partition_weighted_graph_2d(wg, *GRID)
            blocks, nblocks = dwg.g2, GRID[0] * GRID[1]
        rows = out[f"blocks_{kind}"] = {phase: [] for phase in inputs}
        for d in range(nblocks):
            bwg = dwg.local(d, dev)
            bchk = RelaxKernelCheck(bwg)
            masks = phase_masks(bwg, delta)
            for phase, (_, vals) in inputs.items():
                if blocks is not None:
                    vals = column_slice(rows_of(vals, blocks.n, INF), blocks,
                                        d % blocks.pc)
                rows[phase].append(relax_ms(
                    bchk, f"dist_sssp {kind} block {d} {phase}",
                    masks[phase], vals))
            checks.append(bchk)
        del dwg, bwg
    rec = {name: dict(cases=sum(c.rec[name]["cases"] for c in checks),
                      max_abs_err=max(c.rec[name]["max_abs_err"]
                                      for c in checks), sweep_step=out)
           for name in SSSP_KERNELS}
    emit("dist_sssp_kernel", sweep_step=out,
         cases={name: r["cases"] for name, r in rec.items()})
    return rec


def in_rotation(runs: dict, turns: int) -> dict:
    """Each of ``runs``' functions ``turns`` times, the order rotated every
    turn: {name: [seconds]} (host wall, ending with a device sync)."""
    names = list(runs)
    out = {name: [] for name in names}
    for i in range(turns):
        k = i % len(names)
        for name in names[k:] + names[:k]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runs[name]()
            torch.cuda.synchronize()
            out[name].append(time.perf_counter() - t0)
    return out


def step_rows(state, step, idle, steps: int, reps: int):
    """The first ``steps`` steps of an engine from ``state``: each step's
    host syncs (torch's sync debug mode) and wall ms (median of ``reps``;
    a step run again on the state it was given gives the same state)."""
    rows = []
    while not idle(state) and len(rows) < steps:
        rows.append(dict(syncs=syncs_of(lambda: step(state)),
                         step_ms=wall_ms(lambda: step(state), reps)))
        state = step(state)
    return dict(syncs_per_step=sorted({r["syncs"] for r in rows}),
                step_ms_median=statistics.median(r["step_ms"] for r in rows),
                steps=len(rows))


def grid_rank(graph_path, num, sources, reps) -> dict:
    """The dist2d and dist_sssp phases' rank: one NCCL rank on cuda:0, the
    weighted graph by file. dist2d_msbfs on a 1x1 grid at ``num`` and 4x
    ``num`` roots in 64 lanes, dense and compressed, every result field's
    digest against the host engine's, with the launches, layers and bytes
    of each run; the host engine and both formats timed in rotation; each
    format's steps (host syncs, ms); a khop through LaneEngine(grid=(1,
    1)). Then dist_sssp on a 1-rank mesh and dist2d_sssp on the 1x1 grid
    at default_delta, ``sources`` sources in 32 lanes (dense and
    compressed) and twice as many through them (dense), every field
    bit-equal to sssp_pipelined's, with launches, steps and bytes; the host
    engine and both sharded engines timed in rotation; each engine's and
    format's steps."""
    dev = rank_device()
    common.load_library()
    t0 = time.perf_counter()
    wg = load_graph(graph_path, dev)
    g = wg.csr
    out = dict(load_seconds=time.perf_counter() - t0, device=str(dev),
               backend=str(torch.distributed.get_backend()))
    grid = mesh2d(1, 1)
    dg = partition_graph_2d(g, 1, 1)
    dg.local(0, dev)                  # the block on the card before timing
    formats = (("dense", False), ("compressed", True))

    def init2d(rts):
        return dist2d_msbfs_engine_enqueue(
            dist2d_msbfs_engine_init(dg, grid, len(rts), LANES), rts)

    def sweep2d(rts, compress):
        st = dist2d_msbfs_engine_drain(dg, init2d(rts), grid,
                                       compress=compress)
        return st, dist2d_msbfs_engine_result(dg, st, grid)

    msbfs = {}
    for count in (num, 4 * num):
        rts = sample_roots(g, count, seed=SEED + 1)
        want = sweep_digests(msbfs_pipelined(g, rts, "hybrid", lanes=LANES))
        for fmt, compress in formats:
            torch.cuda.synchronize()
            common.reset_launches()
            st, res = sweep2d(rts, compress)
            torch.cuda.synchronize()
            launches = dict(common.LAUNCHES)
            have = sweep_digests(res)
            check(have == want, f"the 2-D sweep of {count} roots ({fmt}) "
                                f"differs from the host engine: {have} {want}")
            msbfs[f"sweep_{count}_{fmt}"] = dict(
                launches=launches, layers=st.sweep_layers,
                exch_bytes=st.exch_bytes,
                bytes_per_layer=st.exch_bytes / st.sweep_layers,
                digests_equal=sorted(want))
            del st, res
        msbfs[f"xreduction_{count}"] = (
            msbfs[f"sweep_{count}_dense"]["exch_bytes"]
            / max(msbfs[f"sweep_{count}_compressed"]["exch_bytes"], 1))
    rts = sample_roots(g, num, seed=SEED + 1)
    torch.cuda.empty_cache()
    msbfs["turns"] = in_rotation(dict(
        host=lambda: msbfs_pipelined(g, rts, "hybrid", lanes=LANES),
        dense=lambda: sweep2d(rts, False),
        compressed=lambda: sweep2d(rts, True)), DIST_TURNS)
    for fmt, compress in formats:
        msbfs[f"steps_{fmt}"] = step_rows(
            init2d(rts), lambda st, c=compress: dist2d_msbfs_engine_step(
                dg, st, grid, compress=c), dist2d_msbfs_engine_idle,
            SYNC_STEPS, reps)
    want = khop_neighborhood(LaneEngine(g, lanes=LANES), rts, 2)
    got = khop_neighborhood(LaneEngine(g, grid=(1, 1), compress=True,
                                       lanes=LANES), rts, 2)
    check(np.array_equal(got.member_mask(), want.member_mask()),
          "khop through LaneEngine(grid=(1, 1)) differs from LaneEngine()")
    msbfs["lane_engine_khop"] = dict(sources=len(rts), k=2,
                                     ndev=got.meta.ndev)
    out["dist2d"] = msbfs
    torch.cuda.empty_cache()

    delta = default_delta(wg)
    mesh = host_mesh(1)
    dwg, dwg2 = partition_weighted_graph(wg, 1), partition_weighted_graph_2d(
        wg, 1, 1)
    dwg.local(0, dev), dwg2.local(0, dev)
    check(default_delta_dist(dwg) == delta == default_delta_dist(dwg2),
          "default_delta_dist differs from default_delta")
    engines = dict(
        dist_sssp=(lambda cap: dist_sssp_engine_init(dwg, mesh, cap,
                                                     SSSP_LANES),
                   lambda st, c: dist_sssp_engine_step(dwg, st, mesh, delta,
                                                       compress=c),
                   lambda st: dist_sssp_engine_result(dwg, st)),
        dist2d_sssp=(lambda cap: dist2d_sssp_engine_init(dwg2, grid, cap,
                                                         SSSP_LANES),
                     lambda st, c: dist2d_sssp_engine_step(dwg2, st, grid,
                                                           delta, compress=c),
                     lambda st: dist2d_sssp_engine_result(dwg2, st)))

    def sweep_sssp(name, srcs, compress):
        init, step, result = engines[name]
        st = sssp_engine_enqueue(init(len(srcs)), srcs)
        while not sssp_engine_idle(st):
            st = step(st, compress)
        return st, result(st)

    many = sample_roots(wg, 2 * sources, seed=SEED + 1)
    sssp = dict(delta=delta)
    for srcs in (many[:sources], many):
        want = sssp_pipelined(wg, srcs, lanes=SSSP_LANES)
        for name in engines:
            for fmt, compress in formats[:2 if len(srcs) == sources else 1]:
                torch.cuda.synchronize()
                common.reset_launches()
                st, res = sweep_sssp(name, srcs, compress)
                torch.cuda.synchronize()
                launches = dict(common.LAUNCHES)
                for f, a, b in zip(res._fields, res, want):
                    if a.is_floating_point():
                        a, b = a.view(torch.int32), b.view(torch.int32)
                    check(torch.equal(a, b),
                          f"{name} ({fmt}, {len(srcs)} sources): {f} "
                          f"differs from sssp_pipelined")
                sssp[f"{name}_{len(srcs)}_{fmt}"] = dict(
                    launches=launches, steps=st.sweep_steps,
                    exch_bytes=st.exch_bytes,
                    bytes_per_step=st.exch_bytes / st.sweep_steps,
                    fields_equal=list(res._fields))
                del st, res
        del want
    srcs = many[:sources]
    sssp["turns"] = in_rotation(dict(
        host=lambda: sssp_pipelined(wg, srcs, lanes=SSSP_LANES),
        dist_sssp=lambda: sweep_sssp("dist_sssp", srcs, False),
        dist2d_sssp=lambda: sweep_sssp("dist2d_sssp", srcs, False)),
        DIST_TURNS)
    for name, (init, step, _) in engines.items():
        for fmt, compress in formats:
            sssp[f"steps_{name}_{fmt}"] = step_rows(
                sssp_engine_enqueue(init(len(srcs)), srcs),
                lambda st, s=step, c=compress: s(st, c), sssp_engine_idle,
                SYNC_STEPS, reps)
    out["dist_sssp"] = sssp
    return out


def run_grid(wg, args, lane_state) -> dict:
    """The dist2d and dist_sssp phases: the kernels on the blocks here, then
    the 1-rank NCCL paths in one rank of run_ranks, the weighted graph
    handed over by file. Checks the launches and the host syncs a step;
    returns the records the kernels line takes."""
    g = wg.csr
    reps = max(args.reps // 4, 3)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=g.device)
    lane = grid_lane_kernels(g, lane_state, reps, flush)
    relax = grid_relax_kernels(wg, args.sources, reps, flush)
    del flush
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_grid_") as tmp:
        path = os.path.join(tmp, "graph.npz")
        save_graph(wg, path)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        out = run_ranks(grid_rank, 1, path, args.roots, args.sources, reps)
    seconds = time.perf_counter() - t0
    msbfs, sssp = out.pop("dist2d"), out.pop("dist_sssp")
    runs = {k: r for k, r in msbfs.items() if k.startswith("sweep_")}
    for key, r in runs.items():
        for name in BATCHED_KERNELS:
            check(r["launches"][name] > 0,
                  f"{name} was not launched by the 2-D {key}")
    sweeps = {k: r for k, r in sssp.items() if k.startswith("dist")}
    for key, r in sweeps.items():
        for name in SSSP_KERNELS:
            check(r["launches"][name] > 0, f"{name} was not launched by {key}")
    # a dense step reads the device back once; a compressed one also reads
    # each of its exchanges' counts
    for key, want in (("steps_dense", [1]), ("steps_compressed", [3])):
        check(msbfs[key]["syncs_per_step"] == want,
              f"a 2-D {key} makes {msbfs[key]['syncs_per_step']} host syncs")
    for key, want in (("steps_dist_sssp_dense", [1]),
                      ("steps_dist_sssp_compressed", [2]),
                      ("steps_dist2d_sssp_dense", [1]),
                      ("steps_dist2d_sssp_compressed", [3])):
        check(sssp[key]["syncs_per_step"] == want,
              f"{key} makes {sssp[key]['syncs_per_step']} host syncs")

    def medians(turns):
        return {k: statistics.median(v) for k, v in turns.items()}
    emit("dist2d", entry="repro_torch.core.dist2d.dist2d_msbfs", grid=[1, 1],
         ranks=1, rank_seconds=seconds, **out, **msbfs,
         turns_median=medians(msbfs["turns"]))
    emit("dist_sssp", entry="repro_torch.core.dist_sssp.{dist_sssp,"
                            "dist2d_sssp}", ranks=1, grid=[1, 1],
         sources=args.sources, lanes=SSSP_LANES, **sssp,
         turns_median=medians(sssp["turns"]))
    rec = {name: dict(lane[name], launches={
        k: r["launches"][name] for k, r in runs.items()})
        for name in BATCHED_KERNELS}
    rec.update({name: dict(relax[name], launches={
        k: r["launches"][name] for k, r in sweeps.items()})
        for name in SSSP_KERNELS})
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=20)
    ap.add_argument("--roots", type=int, default=64)
    ap.add_argument("--sources", type=int, default=32)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default=None,
                    help="also write sssp_layers' per-step rows here")
    ap.add_argument("--u64-child", action="store_true",
                    help="run only the u64 phase's 64-bit half (the script "
                         "starts it itself, with LANE_WORD_BITS=64)")
    args = ap.parse_args(argv)
    if not 1 <= args.sources <= SSSP_LANES:
        ap.error(f"--sources must be in [1, {SSSP_LANES}]")

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    if args.u64_child:
        return u64_child(args, dev)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    emit("device", name=kind, nvidia_smi=smi,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)

    t0 = time.perf_counter()
    common.load_library()
    emit("build", load_seconds=time.perf_counter() - t0,
         nvcc_flags=list(common.NVCC_FLAGS), **common.build_info)

    t0 = time.perf_counter()
    wg = rmat_weighted_graph(args.scale, EDGEFACTOR, seed=SEED)
    g = wg.csr  # equals rmat_graph(scale, EDGEFACTOR, SEED)
    torch.cuda.synchronize()
    csr_bytes = sum(t.numel() * t.element_size() for t in g)
    emit("graph", scale=args.scale, edgefactor=EDGEFACTOR, n=g.n, m=g.m,
         device=str(g.device), csr_bytes=csr_bytes,
         weight_bytes=wg.weights.numel() * wg.weights.element_size(),
         seconds=time.perf_counter() - t0)
    check(g.device.type == "cuda", "graph is not on the GPU")

    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=dev)
    probe_root = int(sample_roots(g, 1, seed=SEED + 1)[0])
    states = bfs(g, probe_root, "hybrid")
    rec = compare_kernels(g, states, dev, args.reps, flush)
    layer_breakdown(g, probe_root, states, max(args.reps // 4, 3), flush,
                    rec)
    torch.cuda.reset_peak_memory_stats()

    res, launches = run_main_path(g, args)

    chk = LaneKernelCheck(g)
    lane_kernel_random(chk, dev, args.reps, flush)
    sweep_roots = sample_roots(g, args.roots, seed=SEED + 1)
    layers = batched_layers(g, sweep_roots, chk, max(args.reps // 4, 3),
                            flush)
    for name, r in chk.rec.items():
        emit("msbfs_kernel", name=name, bit_equal=True, **r)
    run_parents_kernel(g, sweep_roots, args.reps, flush)

    delta = default_delta(wg)
    rchk = RelaxKernelCheck(wg)
    relax_kernel_random(rchk, dev, args.reps, flush, delta)
    sssp_layers(wg, sample_roots(wg, args.sources, seed=SEED + 1), rchk,
                max(args.reps // 4, 3), flush, delta, args.out)
    for name, r in rchk.rec.items():
        emit("sssp_kernel", name=name, bit_equal=True, **r)
    del flush
    batched_launches = run_batched_path(g, args, res)
    sssp_launches, sssp_steps, sssp_points = run_sssp_path(wg, args)

    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=dev)
    gchk = GnnKernelCheck()
    gnn_kernel(gchk, g, dev, args.reps, flush)
    gcn_layers(dev, max(args.reps // 4, 3), flush)
    del flush
    gcn_launches = run_gcn_path(dev)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=dev)
    gin = run_gnn_zoo(dev, smi, max(args.reps // 4, 3), flush)
    del flush
    sharded = run_sharded(dev, smi, max(args.reps // 4, 3))
    run_dien(dev, smi)
    run_lm(dev, smi)

    figure_tables(g, args, states)
    figure3(g, args)
    run_analytics(wg, args, sssp_points)
    serve_launches, serve_host = run_serve(wg, args)
    run_hillclimb(g, args)
    run_serve_bench(wg, args)
    serve_dist_launches = run_serve_dist(wg, args, serve_host)
    example_launches = run_examples(args)
    lane_state = sweep_layer_state(g, sample_roots(g, LANES, seed=SEED + 1))
    dist = run_dist(g, args, states, lane_state)
    grid = run_grid(wg, args, lane_state)
    del lane_state
    u64 = run_u64(wg, args)
    run_dryrun(args, smi)

    kernels = []
    for name in KERNELS:
        serial = name in SERIAL_KERNELS
        if name in GNN_KERNELS:
            r, count = gchk.rec[name], gcn_launches[name]
            per = dict(launches_per_step=count / GCN_STEPS,
                       max_bound_ratio=r["max_bound_ratio"],
                       inputs=r["inputs"],
                       **{k: r[k] for k in ("bit_equal_f32", "max_abs_err_f64")
                          if k in r})
            # GIN (gin-tu): the Trainer's launches, the example's, and
            # the kernel on GIN's inputs (bit-equal, timed)
            g = gin["rec"][name]
            per["gin"] = dict(
                launches={k: v["launches"][name]
                          for k, v in gin["runs"].items()},
                launches_per_step={k: v["launches_per_step"][name]
                                   for k, v in gin["runs"].items()},
                example_launches=gin["example_launches"][name],
                bit_equal=True, max_abs_err=g["max_abs_err"],
                max_bound_ratio=g["max_bound_ratio"], inputs=g["inputs"])
            # the sharded step: the kernel on each block of a 4-way edge
            # partition (owner_gather_scatter's local body) and its
            # launches in each sharded gin-tu step on a 1-rank mesh
            per["sharded"] = sharded[name]
        elif name in SSSP_KERNELS:
            r, count = rchk.rec[name], sssp_launches[name]
            per = dict(launches_per_step=count / sssp_steps)
            if "sweep_inputs" in r:
                per["sweep_inputs"] = r["sweep_inputs"]
        elif serial:
            # the serial harness runs one BFS per root plus a warm-up root
            r, count = rec[name], launches[name]
            per = dict(launches_per_bfs=count / (len(res.roots) + 1))
        else:
            # the batched harness runs the sweep twice (warm-up and timed)
            r, count = chk.rec[name], batched_launches[name]
            per = dict(launches_per_sweep_layer=count / (2 * layers))
        for key in ("forms", "layers"):
            if key in r:
                per[key] = r[key]
        if name in SERVE_KERNELS:
            per["serve_launches"] = serve_launches[name]
            # the sharded pools on one NCCL rank, part by part
            per["serve_dist_launches"] = {
                part: counts[name]
                for part, counts in serve_dist_launches.items()}
        if example_launches[name]:
            per["examples_launches"] = example_launches[name]
        if name in BATCHED_KERNELS:
            # int64 words through the int32 view: the child's main-path
            # launches, its bit-equal cases, its times against the 32-bit
            # kernel on the same planes
            per["u64"] = dict(launches=u64["launches"][name],
                              dist_launches=u64["dist_launches"][name],
                              dist2d_launches=u64["dist2d_launches"][name],
                              bit_equal=True, **u64["kernels"][name],
                              widths=u64["kernel_widths"][name])
        if name in DIST_KERNELS:
            # the sharded path: launches on the 1-rank NCCL mesh, and the
            # kernel on each block of a 4-way partition against the global
            # frontier (bit-equal; block and whole-graph ms)
            per["dist"] = dict(bit_equal=True, **dist[name])
        if name in grid:
            # the 2-D and the distributed SSSP engines: launches on the
            # 1-rank paths, and the kernel on each block of the 2x2 grid
            # (and, for B4 and X2, of the 4-way partition), bit-equal
            per["dist2d" if name in BATCHED_KERNELS else "dist_sssp"] = dict(
                bit_equal=True, **grid[name])
        kernels.append(dict(
            name=name, **KERNELS[name], launches=count, **per,
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r.get("library_ms")))
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
