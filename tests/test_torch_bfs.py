"""The port's hybrid BFS and Graph500 harness against the JAX package.

The same graph (carried over with ``from_numpy_graph``), root and arguments
go through ``repro.core.hybrid.bfs`` and ``repro_torch.core.hybrid.bfs``;
all eight ``BFSResult`` fields must be equal, bit for bit. On the CPU the
port's steps take the kernels' plain versions.
"""
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hybrid as jhybrid
from repro.core.bottomup import bottomup_probe_stats as j_probe_stats
from repro.core.csr import to_numpy_adj
from repro.core.topdown import topdown_active_lanes as j_active_lanes
from repro.graph import graph500 as jgraph500
from repro.graph.generator import rmat_graph as jrmat
from repro.graph.generator import sample_roots
from repro.graph.generator import uniform_random_graph as juniform
from repro.graph.validate import validate_bfs_tree as j_validate
from repro_torch.core import hybrid
from repro_torch.core.bottomup import bottomup_probe_stats
from repro_torch.core.csr import from_numpy_graph
from repro_torch.core.ref import bfs_reference
from repro_torch.core.topdown import topdown_active_lanes
from repro_torch.graph.graph500 import run_graph500
from repro_torch.graph.validate import validate_bfs_tree
from repro_torch.launch import bfs as launch_bfs

MODES = ["hybrid", "topdown", "bottomup_simd", "bottomup_nosimd",
         "hybrid_nosimd"]
COMBOS = [(td_impl, skip) for td_impl in ("edge", "ell")
          for skip in (True, False)]
RANDOM_GRAPHS = [(10, 10, 0), (37, 80, 1), (128, 512, 2), (400, 1200, 3),
                 (61, 15, 4)]


def port_graph(jg):
    return from_numpy_graph(np.asarray(jg.row_ptr), np.asarray(jg.col_idx),
                            np.asarray(jg.src_idx), "cpu")


def assert_results_equal(t_out, j_out, what=""):
    assert isinstance(t_out, hybrid.BFSResult)
    for name in hybrid.BFSResult._fields:
        t = getattr(t_out, name)
        assert t.dtype == torch.int32, name
        np.testing.assert_array_equal(t.numpy(), np.asarray(getattr(j_out,
                                                                    name)),
                                      err_msg=f"{name} {what}")


def reference_args(key, mode, td_impl, skip):
    """The JAX arguments to hold the port's run against.

    On the R-MAT graph: the same arguments, except those the mode never
    reads (a mode that never goes top-down ignores td_impl; only the SIMD
    bottom-up reads skip_empty_fallback). On the small random graphs: the
    mode's default arguments, because td_impl and skip_empty_fallback
    change how a step computes its layer, never the layer, so every field
    of the reference's result is the same for all of them (the R-MAT
    matrix holds both packages to that). Each folded argument saves a JAX
    compilation; the port still runs every combination."""
    if key != "rmat":
        return mode, "edge", True
    if mode in ("bottomup_simd", "bottomup_nosimd"):
        td_impl = "edge"
    if mode not in ("hybrid", "bottomup_simd"):
        skip = True
    return mode, td_impl, skip


@pytest.fixture(scope="module")
def graphs():
    return {"rmat": jrmat(10, 16, seed=0)} | {
        f"G{n},{m},{s}": juniform(n, m, seed=s) for n, m, s in RANDOM_GRAPHS}


def roots_of(key, jg):
    if key == "rmat":
        return [int(r) for r in sample_roots(jg, 3, seed=1)]
    seed = int(key.split(",")[-1])
    candidates = np.flatnonzero(np.asarray(jg.deg) > 0)
    return [int(candidates[seed % len(candidates)])]


@pytest.mark.parametrize("key", ["rmat"] + [f"G{n},{m},{s}"
                                            for n, m, s in RANDOM_GRAPHS])
@pytest.mark.parametrize("mode", MODES)
def test_all_fields_match_reference(graphs, key, mode):
    jg = graphs[key]
    g = port_graph(jg)
    for root in roots_of(key, jg):
        cache = {}
        for td_impl, skip in COMBOS:
            args = reference_args(key, mode, td_impl, skip)
            if args not in cache:
                m, t, s = args
                cache[args] = jhybrid.bfs(jg, root, m, 14.0, 24.0, 8, "xla", s,
                                          t)
            out = hybrid.bfs(g, root, mode, 14.0, 24.0, 8, skip, td_impl)
            assert_results_equal(out, cache[args],
                                 f"{key} root {root} {mode} {td_impl} {skip}")


def test_reference_pallas_probe_leg(graphs):
    jg = graphs["rmat"]
    g = port_graph(jg)
    root = int(sample_roots(jg, 1, seed=2)[0])
    j_out = jhybrid.bfs(jg, root, "hybrid", 14.0, 24.0, 8, "pallas")
    assert_results_equal(hybrid.bfs(g, root, "hybrid"), j_out)


@pytest.mark.parametrize("max_pos", [1, 4, 8, 32])
def test_max_pos_invariance(graphs, max_pos):
    jg = graphs["rmat"]
    g = port_graph(jg)
    rp, ci = to_numpy_adj(jg)
    root = int(sample_roots(jg, 1, seed=3)[0])
    out = hybrid.bfs(g, root, "bottomup_simd", 14.0, 24.0, max_pos)
    assert_results_equal(
        out, jhybrid.bfs(jg, root, "bottomup_simd", 14.0, 24.0, max_pos))
    pref, dref = bfs_reference(rp, ci, root)
    np.testing.assert_array_equal(out.parent.numpy(), pref)
    np.testing.assert_array_equal(out.depth.numpy(), dref)


@pytest.mark.parametrize("mode", ["hybrid", "bottomup_nosimd"])
def test_port_trees_pass_both_validators(graphs, mode):
    jg = graphs["rmat"]
    g = port_graph(jg)
    rp, ci = to_numpy_adj(jg)
    for root in sample_roots(jg, 3, seed=4):
        parent = hybrid.bfs(g, int(root), mode).parent.numpy()
        assert (validate_bfs_tree(rp, ci, parent, int(root))
                == j_validate(rp, ci, parent, int(root)))


def test_hybrid_trace_pattern(graphs):
    """Paper Table 2: TD on the first layer, BU in the middle layers."""
    g = port_graph(graphs["rmat"])
    root = int(sample_roots(graphs["rmat"], 1, seed=1)[0])
    out = hybrid.bfs(g, root, "hybrid")
    dirs = out.trace_dir[:int(out.num_layers)].numpy()
    assert dirs[0] == 0 and (dirs == 1).any()
    assert (out.trace_dir[int(out.num_layers):] == -1).all()


def test_switch_direction_matches_reference():
    """Both packages take the same branch, including where e_u / alpha is
    one float32 rounding away from an integer e_f."""
    rng = np.random.default_rng(0)
    alphas = [14.0, 3.0, 7.0, 0.3]
    eu = rng.integers(0, 2 ** 31 - 1, size=4000)
    eu[:1000] = rng.integers(0, 50_000, size=1000)
    n = 1 << 20

    @functools.partial(jax.jit, static_argnums=(4, 5))
    def ref(td, e_f, v_f, e_u, alpha, beta):
        return jhybrid.switch_direction(td, e_f, v_f, e_u, n, alpha, beta)

    for alpha in alphas:
        ef = np.floor(eu.astype(np.float32) / np.float32(alpha)).astype(
            np.int64) + rng.integers(-1, 2, size=eu.shape)
        ef = np.clip(ef, 0, 2 ** 31 - 1)
        vf = rng.integers(0, 2 * n // 24, size=eu.shape)
        for td in (True, False):
            tdv = np.full(eu.shape, td)
            want = np.asarray(ref(jnp.asarray(tdv), jnp.asarray(ef, jnp.int32),
                                  jnp.asarray(vf, jnp.int32),
                                  jnp.asarray(eu, jnp.int32), alpha, 24.0))
            got = hybrid.switch_direction(tdv, ef, vf, eu, n, alpha, 24.0)
            np.testing.assert_array_equal(got, want, err_msg=f"alpha {alpha}")


def test_counters_and_probe_stats_match(graphs):
    jg = graphs["rmat"]
    g = port_graph(jg)
    rng = np.random.default_rng(9)
    vis = rng.random(jg.n) < 0.5
    fro = (rng.random(jg.n) < 0.2) & vis
    assert int(topdown_active_lanes(g, torch.from_numpy(fro))) == int(
        j_active_lanes(jg, jnp.asarray(fro)))
    for max_pos in (1, 8):
        got = bottomup_probe_stats(g, torch.from_numpy(fro),
                                   torch.from_numpy(vis), max_pos)
        want = j_probe_stats(jg, jnp.asarray(fro), jnp.asarray(vis), max_pos)
        assert {k: int(v) for k, v in got.items()} == {
            k: int(v) for k, v in want.items()}


def test_run_graph500_matches_reference_harness():
    j_res = jgraph500.run_graph500(8, 16, num_roots=4, seed=0)
    t_res = run_graph500(8, 16, num_roots=4, seed=0, validate=True,
                         device="cpu")
    jg = jrmat(8, 16, seed=0)
    assert t_res.roots == [int(r) for r in sample_roots(jg, 4, seed=1)]
    assert t_res.traversed == j_res.traversed
    assert t_res.device == "cpu" and len(t_res.times) == 4
    s = t_res.summary()
    assert s["nroots"] == 4 and s["harmonic_mean_teps"] > 0


@pytest.mark.parametrize("kw,exc,match", [
    # the sharded sweep needs the ranks of a process group
    (dict(batched=True, ndev=2), RuntimeError, "run_ranks"),
    # as in the reference, the serial harness has no distributed form
    (dict(ndev=2), ValueError, "requires batched=True")])
def test_run_graph500_unported_paths_raise(kw, exc, match):
    with pytest.raises(exc, match=match):
        run_graph500(6, 4, num_roots=2, device="cpu", **kw)


def test_launch_cli_prints_summary(capsys):
    launch_bfs.main(["--scale", "7", "--roots", "3", "--validate",
                     "--device", "cpu"])
    s = json.loads(capsys.readouterr().out)
    assert s["scale"] == 7 and s["nroots"] == 3 and s["device"] == "cpu"
