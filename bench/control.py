"""The upper readings of a cell's check, on the card at the cell's own size:
its control, and the faults its program can have.

    python3 bench/control.py --workload s20-depths-64 --seeds 11 12 13
    python3 bench/control.py --workload s20-depths-64 --seeds 11 12 13 \
        --fault all --seconds 4

The control is the cell's plain reference computed the tempting wrong way,
put in the program's place for the requests that a run of each seed checks
first, and judged by the cell's own check. A fault (``--fault <name>`` or
``all``: the names the cell's driver gives) is planted in the program for
a whole run of the harness, a window of ``--seconds`` that has to reach the
traffic's ``check_from`` requests, and read by its check. Every seed must
come out not correct. Prints one JSON line a seed (and fault): the compared
numbers beside their limits, and whether the check passed.
"""
import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent / "src")]

import torch  # noqa: E402

import harness  # noqa: E402


def _verdict(checks: dict, failed: int) -> dict:
    return dict(failed=int(failed),
                correct=failed == 0 and all(v <= lim for v, lim in
                                            checks.values()),
                checks={k: dict(value=v, limit=lim)
                        for k, (v, lim) in checks.items()})


def readings(spec, name: str, seed: int, device) -> dict:
    """The control's readings on the requests a run of ``seed`` checks
    first."""
    t0 = time.perf_counter()
    cell = harness.Cell(spec, name, seed, device, program=False)
    count = cell.traffic["check_from"]
    cell.draw_sample(count)
    stream = cell.driver.requests(cell.data, cell.traffic,
                                  seed)(harness.ROOT_SALT)
    reqs = [next(stream) for _ in range(count)]
    samples = [(reqs[i], cell.driver.control(cell.data, reqs[i],
                                             cell.traffic))
               for i in sorted(cell.sample)]
    checks, failed = cell.driver.check(cell.data, samples, cell.traffic)
    return dict(workload=name, seed=seed, **_verdict(checks, failed),
                seconds=time.perf_counter() - t0)


def faults(spec, name: str) -> dict:
    """The faults the cell's driver names: {name: (target, make)}."""
    traffic = spec.traffic(spec.cell(name))
    return spec.module("drivers", traffic["driver"]).faults(traffic)


def fault_readings(spec, name: str, fault: str, seed: int, seconds: float,
                   device) -> dict:
    """A whole run of the cell with ``fault`` planted in the program."""
    t0 = time.perf_counter()
    target, make = faults(spec, name)[fault]
    with harness.Patches() as p:
        p.wrap(target, make)
        result, checks = harness.run(spec, name, seed, seconds, False, t0,
                                     device, log=lambda line: None)
    return dict(workload=name, fault=fault, seed=seed,
                attempted=result["attempted"],
                **_verdict(checks, result["failed"]),
                seconds=time.perf_counter() - t0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault", help="a fault the cell's driver names, or "
                    "'all'; without it, the control")
    ap.add_argument("--seconds", type=float, default=10.0,
                    help="the window of a run with a fault")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench: no CUDA device", file=sys.stderr)
        return 2
    spec = harness.Spec(BENCH.parent)
    device = torch.device("cuda", 0)
    names = (list(faults(spec, args.workload)) if args.fault == "all"
             else [args.fault])
    for seed in args.seeds:
        if args.fault is None:
            out = [readings(spec, args.workload, seed, device)]
        else:
            out = [fault_readings(spec, args.workload, f, seed, args.seconds,
                                  device) for f in names]
        for line in out:
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
