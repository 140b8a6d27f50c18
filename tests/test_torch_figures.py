"""The port's figure scripts (``repro_torch.benchmarks.table2_switching``,
``table3_maxpos``, ``table4_counters``, ``fig3_teps``) against the
reference's scripts under ``benchmarks/``, loaded from their files.

Both run on the same small Graph500 graph (the port on the CPU, through the
kernels' plain versions); every counter of Tables 2-4 must be equal, row
for row. Times are not compared; Fig. 3's result keys must be the
reference's.
"""
import importlib.util
from pathlib import Path

import pytest

from repro_torch.benchmarks import (fig3_teps, table2_switching,
                                    table3_maxpos, table4_counters)

BENCH = Path(__file__).resolve().parent.parent / "benchmarks"
TABLE4_COUNTERS = ("layer", "nv", "nosimd_lanes", "probe_lanes", "retired",
                   "residue")


def reference_script(name):
    spec = importlib.util.spec_from_file_location(f"reference_{name}",
                                                  BENCH / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ref():
    return {name: reference_script(name) for name in (
        "table2_switching", "table3_maxpos", "table4_counters", "fig3_teps")}


@pytest.mark.parametrize("scale,edgefactor", [(8, 16), (7, 8)])
def test_table2_rows_match_reference(ref, scale, edgefactor):
    want = ref["table2_switching"].run(scale, edgefactor)
    got = table2_switching.run(scale, edgefactor, device="cpu")
    assert got == want and len(got) > 2
    assert {r["approach"] for r in got} == {"top-down", "bottom-up"}


@pytest.mark.parametrize("scale,edgefactor", [(8, 16), (7, 8)])
def test_table3_rows_match_reference(ref, scale, edgefactor):
    want = ref["table3_maxpos"].run(scale, edgefactor)
    got = table3_maxpos.run(scale, edgefactor, device="cpu")
    assert got == want and got


@pytest.mark.parametrize("scale,edgefactor,max_pos", [(8, 32, 8), (7, 16, 2)])
def test_table4_counters_match_reference(ref, scale, edgefactor, max_pos):
    want = ref["table4_counters"].run(scale, edgefactor, max_pos=max_pos)
    got = table4_counters.run(scale, edgefactor, max_pos=max_pos,
                              device="cpu")
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        assert {k: g[k] for k in TABLE4_COUNTERS} == \
            {k: w[k] for k in TABLE4_COUNTERS}
        assert set(g) == set(w)
        assert g["t_nosimd_ms"] > 0 and g["t_simd_ms"] > 0


def test_fig3_keys_match_reference(ref):
    args = dict(scales=(6,), edgefactors=(4, 8), roots=2)
    want = ref["fig3_teps"].run(**args)
    got = fig3_teps.run(**args, device="cpu")
    assert list(got) == list(want)
    assert all(v > 0 for v in got.values())


@pytest.mark.parametrize("script,argv", [
    (table2_switching, ["--scale", "6"]),
    (table3_maxpos, ["--scale", "6"]),
    (table4_counters, ["--scale", "6", "--max-pos", "4"]),
    (fig3_teps, ["--scale", "6", "--edgefactors", "4", "--roots", "2"]),
], ids=lambda a: getattr(a, "__name__", "").rsplit(".", 1)[-1] or None)
def test_main_runs_on_cpu(script, argv, capsys):
    out = script.main(argv + ["--device", "cpu"])
    assert out
    assert "analog" in capsys.readouterr().out
