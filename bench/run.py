"""The benchmark's one command: one run of one cell.

    python3 bench/run.py --workload s20-depths-64 --seed 7 --seconds 30 \
        --trace 0

Prints progress as JSON lines on standard error, then each compared number
beside its limit, and as the last line of standard output one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics``, ``device`` (and with
``--trace 1`` ``breakdown``), with ``checks`` last. Exits 2, printing no
result, where the card or the program is missing, and 3 where a module of
JAX or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()  # set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def log(line: str) -> None:
    print(line, file=sys.stderr, flush=True)


def fail(code: int, msg: str):
    log(f"bench: {msg}")
    sys.exit(code)


def refuse_forbidden(names) -> None:
    """Exit 3, printing no result, where a module of JAX or the JAX
    package is loaded once the window has closed."""
    if names:
        top = sorted({name.split(".")[0] for name in names})
        fail(3, f"{len(names)} modules of JAX or the JAX package are "
                f"loaded, under {', '.join(top)}")


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    # every cache of the program and of the libraries it uses stays in the
    # checkout, at a fixed path; the kernels' own build directory is
    # src/repro_torch/_build, also in the checkout
    cache = ROOT / ".bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(2, f"the program (src/repro_torch) is not in {ROOT}")
    sys.path[:0] = [str(BENCH), str(ROOT / "src")]
    import torch
    import harness
    spec = harness.Spec(ROOT)
    cell = spec.cell(args.workload)
    if not torch.cuda.is_available():
        fail(2, "no CUDA device")
    if torch.cuda.device_count() < cell["chips"]:
        fail(2, f"{cell['chips']} cards wanted, "
                f"{torch.cuda.device_count()} present")
    result, checks = harness.run(
        spec, args.workload, args.seed, args.seconds, bool(args.trace),
        T_START, torch.device("cuda", 0), log)
    refuse_forbidden(harness.forbidden_modules())
    for name, (value, limit) in checks.items():
        log(f"check {name} {value!r} limit {limit!r}")
    result["checks"] = {name: dict(value=value, limit=limit)
                        for name, (value, limit) in checks.items()}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
