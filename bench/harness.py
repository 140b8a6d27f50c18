"""One run of one cell: set-up, the measured window, the traced window with
the count pass, the check against the plain reference, and the result.

Everything a cell is made of is found by name, as data, each looked up in
the benchmark's ``paths`` in order: the cell in ``BENCHMARK.json``; its
configuration's file, and the module ``generators/<generator>.py`` that
its ``generator`` names; its traffic file ``workloads/<traffic>.json``
and the module ``drivers/<driver>.py`` that its ``driver`` names; and a
reader ``metrics/<metric>.py`` for each metric, end to end and per layer.

A generator module has ``build(cfg, seed, device) -> data``: the system's
data (a graph, tables), made on the device from the configuration and the
run's seed, as a tensor or a tuple or dict of them. A driver module has

    Program(data, traffic, seed, device)  the system under test, built on
                                          the data; ``.loop(salt)`` yields
                                          a ``loops.Record`` as each
                                          request finishes, drawing its
                                          requests from (seed, salt), in
                                          the driver's own pattern of
                                          arrivals
    requests(data, traffic, seed)         the same request stream without
                                          a program: ``(salt)`` -> inputs
    check(data, samples, traffic)         compare (request, answer) pairs
        -> ({name: (value, limit)}, failed)   with the plain reference;
                                          failed counts the sampled
                                          requests with a wrong answer
    control(data, request, traffic)       the reference computed the
                                          tempting wrong way, an answer
    faults(traffic)                       {name: ("module:attr", make)}:
                                          the faults a cell can have

The harness keeps the window: it takes records until the window's time is
up, keeps the sampled answers, and hands the records to the end-to-end
readers, ``read(window) -> float``. A per-layer reader has ``read(trace)
-> float | None`` (None: nothing to read, and the metric is left out),
with optional ``SPANS`` (name -> "module:attr" of the program to time in
the traced window) and ``COUNTS`` (op -> ("module:attr", bound function))
for the count pass. The check runs on the harness's own copy of the data,
kept on the host while the program runs, so nothing the program does to
its data reaches the reference.
"""
from __future__ import annotations

import functools
import importlib
import importlib.util
import itertools
import json
import statistics
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

import profiling
from loops import sync

# modules that no run may load: the JAX reference package and JAX itself
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
ROOT_SALT = 0x726F6F74      # the window's requests
WARM_SALT = 0x7761726D      # the warm-up's requests
SAMPLE_SALT = 0x73616D70    # which requests are checked


class Spec:
    """``BENCHMARK.json`` of a checkout, and the files it names."""

    def __init__(self, root: Path):
        self.root = Path(root)
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())
        self.dirs = [self.root / p for p in self.data["paths"]]

    def find(self, kind: str, name: str) -> Path:
        for d in self.dirs:
            path = d / kind / name
            if path.is_file():
                return path
        raise FileNotFoundError(f"no {kind}/{name} under {self.dirs}")

    def cell(self, name: str) -> dict:
        cells = {c["name"]: c for c in self.data["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        return cells[name]

    def config(self, cell: dict) -> dict:
        cfg = {c["name"]: c for c in self.data["configs"]}[cell["config"]]
        return json.loads((self.root / cfg["file"]).read_text())

    def traffic(self, cell: dict) -> dict:
        return json.loads(self.find("workloads",
                                    cell["traffic"] + ".json").read_text())

    def module(self, kind: str, name: str):
        return load_module(self.find(kind, name + ".py"), f"bench_{kind}")

    def end_to_end(self, cell: dict) -> list[dict]:
        """The end-to-end metrics the cell reports: those that list it,
        and those with no list."""
        return [m for m in self.data["end_to_end"]
                if cell["name"] in m.get("workloads", [cell["name"]])]

    def per_layer(self, cell: dict) -> list[dict]:
        """The per-layer metrics that list the cell."""
        return [m for m in self.data["per_layer"]
                if cell["name"] in m["workloads"]]


@functools.cache
def load_module(path: Path, prefix: str):
    """A module from a file of the benchmark, by path (metric names hold
    dots, so they are not import names)."""
    name = f"{prefix}_{path.stem.replace('.', '_').replace('-', '_')}"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Patches:
    """Attributes of the program replaced for one pass and put back. A
    target is ``module:function`` or ``module:Class.method``."""

    def __init__(self):
        self.saved = []

    def wrap(self, target: str, make):
        module, path = target.split(":")
        owner = importlib.import_module(module)
        *outer, attr = path.split(".")
        for name in outer:
            owner = getattr(owner, name)
        orig = getattr(owner, attr)
        self.saved.append((owner, attr, orig))
        setattr(owner, attr, make(orig))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for owner, attr, orig in reversed(self.saved):
            setattr(owner, attr, orig)


def span(name: str, trace: profiling.Trace, device):
    """A wrapper that times each call, the device synchronised at both
    ends, into ``trace.spans[name]``."""
    def make(orig):
        @functools.wraps(orig)
        def timed(*args, **kwargs):
            sync(device)
            t0 = time.perf_counter()
            with torch.profiler.record_function(name):
                out = orig(*args, **kwargs)
                sync(device)
            trace.spans.setdefault(name, []).append(time.perf_counter() - t0)
            return out
        return timed
    return make


def counting(op: str, cost, trace: profiling.Trace):
    """A wrapper that adds the bound of each launch, from its arguments
    before it runs, to ``trace.bounds[op]``."""
    def make(orig):
        @functools.wraps(orig)
        def counted(*args, **kwargs):
            trace.bounds.setdefault(op, []).append(cost(*args, **kwargs))
            return orig(*args, **kwargs)
        return counted
    return make


def move(data, device):
    """``data`` (a tensor, or a tuple, named tuple or dict of them) with
    every tensor copied to ``device``."""
    if isinstance(data, torch.Tensor):
        return data.to(device, copy=True)
    if isinstance(data, dict):
        return {k: move(v, device) for k, v in data.items()}
    if isinstance(data, tuple):
        items = [move(v, device) for v in data]
        return type(data)(*items) if hasattr(data, "_fields") else \
            tuple(items)
    return data


def forbidden_modules() -> list[str]:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


@dataclass
class Window:
    """What the end-to-end readers read: the records of the window's
    requests (answers dropped), its length, the device's peak bytes in it,
    and the run's set-up seconds."""
    records: list = field(default_factory=list)
    seconds: float = 0.0
    peak_bytes: int = 0
    setup_s: float = 0.0


class Cell:
    """A cell made ready to run: its files, data and program. Set-up's
    phases are timed into ``phases``."""

    def __init__(self, spec: Spec, name: str, seed: int, device,
                 program: bool = True):
        self.phases = {}
        t = time.perf_counter()

        def phase(what):
            nonlocal t
            sync(device)
            now = time.perf_counter()
            self.phases[what] = now - t
            t = now

        self.spec = spec
        self.cell = spec.cell(name)
        self.cfg = spec.config(self.cell)
        self.traffic = spec.traffic(self.cell)
        self.driver = spec.module("drivers", self.traffic["driver"])
        self.seed = seed
        self.device = device
        self.sample = set()
        data = spec.module("generators", self.cfg["generator"]).build(
            self.cfg, seed, device)
        phase("data")
        if not program:
            self.data = data
            return
        # the reference's own copy, where the program cannot write to it
        self.ref = move(data, "cpu")
        phase("reference_copy")
        self.program = self.driver.Program(data, self.traffic, seed, device)
        del data
        phase("program")
        warm = self.program.loop(WARM_SALT)
        for rec in itertools.islice(warm, self.traffic["warm_requests"]):
            pass
        warm.close()
        phase("warm")
        # host buffers for the checked answers, allocated now: a pinned copy
        # takes a few ms of the window, a pageable one ten times that
        pin = device.type == "cuda"
        self.spare = [{k: torch.empty(v.shape, dtype=v.dtype, pin_memory=pin)
                       for k, v in rec.answer.items()}
                      for _ in range(self.traffic["check_requests"])]
        del rec
        phase("pinned_buffers")

    def draw_sample(self, count: int) -> None:
        """Which of the first ``count`` requests of a window are checked:
        ``check_requests`` of them, drawn from the seed."""
        self.sample = set(np.random.default_rng(
            [int(self.seed) % (1 << 63), SAMPLE_SALT]).choice(
                count, min(self.traffic["check_requests"], count),
                replace=False).tolist())

    def take(self, i: int, rec, samples: list):
        """Record ``i`` of a window, its answer copied out if it is
        sampled, and dropped."""
        if i in self.sample:
            kept = self.spare[len(samples)]
            for k, v in rec.answer.items():
                kept[k].copy_(v)
            samples.append((rec.request, kept))
        rec.answer = None
        return rec

    def chips(self) -> list:
        """The cards the cell uses, from the run's device on."""
        if self.device.type != "cuda":
            return []
        first = self.device.index or 0
        return [torch.device("cuda", first + i)
                for i in range(self.cell["chips"])]

    def reset_peak(self):
        for d in self.chips():
            torch.cuda.reset_peak_memory_stats(d)

    def peak(self) -> int:
        """The allocator's peak on the fullest of the cell's cards."""
        return max((torch.cuda.max_memory_allocated(d)
                    for d in self.chips()), default=0)

    def window(self, seconds: float):
        """The measured window: the driver's loop until the first request
        that ends after ``seconds``. Returns (window, samples)."""
        w, samples = Window(), []
        self.draw_sample(self.traffic["check_from"])
        self.reset_peak()
        loop = self.program.loop(ROOT_SALT)
        w0 = time.perf_counter()
        for i, rec in enumerate(loop):
            w.records.append(self.take(i, rec, samples))
            if time.perf_counter() - w0 >= seconds:
                break
        w.seconds = time.perf_counter() - w0
        loop.close()
        w.peak_bytes = self.peak()
        return w, samples

    def traced_window(self, readers: dict):
        """The traced window over the first ``trace_requests`` requests,
        spans on, then the count pass over the same requests. Returns
        (trace, samples, peak bytes)."""
        trace = profiling.Trace()
        spans = {}
        for r in readers.values():
            spans.update(getattr(r, "SPANS", {}))
        count = self.traffic["trace_requests"]
        samples = []
        self.draw_sample(count)
        self.reset_peak()
        with Patches() as p:
            for name, target in spans.items():
                p.wrap(target, span(name, trace, self.device))
            with profiling.traced(trace, set(spans)):
                loop = self.program.loop(ROOT_SALT)
                for i, rec in zip(range(count), loop):
                    self.take(i, rec, samples)
                loop.close()
        peak = self.peak()
        trace.requests = count
        counts = {}
        for r in readers.values():
            counts.update(getattr(r, "COUNTS", {}))
        if counts:
            with Patches() as p:
                for op, (target, cost) in counts.items():
                    p.wrap(target, counting(op, cost, trace))
                loop = self.program.loop(ROOT_SALT)
                for _ in zip(range(count), loop):
                    pass
                loop.close()
                sync(self.device)
        return trace, samples, peak

    def check(self, samples):
        """Free the program, then compare the kept answers with the plain
        reference on the harness's own copy of the data: ({name: (value,
        limit)}, failed requests). A sampled request that the window did
        not reach counts as failed."""
        self.program = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        data = move(self.ref, self.device)
        checks, failed = self.driver.check(data, samples, self.traffic)
        missing = len(self.sample) - len(samples)
        checks["missing_answers"] = (missing, 0)
        return checks, failed + missing


def device_info(cell: Cell, peak: int) -> dict:
    if cell.device.type != "cuda":
        return dict(platform="cpu", kind="cpu", count=1,
                    memory_peak_bytes=int(peak))
    return dict(platform="gpu", kind=torch.cuda.get_device_name(cell.device),
                count=len(cell.chips()), memory_peak_bytes=int(peak))


def run(spec: Spec, name: str, seed: int, seconds: float, trace: bool,
        t_start: float, device, log=print):
    """One run of cell ``name``. Returns (result dict, checks) where the
    result is the contract's last line without its checks."""
    t_cell = time.perf_counter()
    cell = Cell(spec, name, seed, device)
    setup_s = time.perf_counter() - t_start
    log(json.dumps(dict(cell=name, seed=seed, setup_s=setup_s,
                        setup_phases=dict(start=t_cell - t_start,
                                          **cell.phases),
                        traffic=cell.traffic)))
    if not trace:
        w, samples = cell.window(seconds)
        w.setup_s = setup_s
        attempted = len(w.records)
        metrics = {}
        for m in spec.end_to_end(cell.cell):
            value = spec.module("metrics", m["name"]).read(w)
            metrics[m["name"]] = dict(value=value, unit=m["unit"])
        lat = [r.latency_s for r in w.records]
        work = {k: sum(r.work[k] for r in w.records)
                for k in w.records[0].work}
        log(json.dumps(dict(window_s=w.seconds, requests=attempted,
                            work=work,
                            latency_ms_median=statistics.median(lat) * 1e3,
                            latency_ms_max=max(lat) * 1e3)))
        dev = device_info(cell, w.peak_bytes)
    else:
        want = spec.per_layer(cell.cell)
        readers = {m["name"]: spec.module("metrics", m["name"])
                   for m in want}
        tr, samples, peak = cell.traced_window(readers)
        attempted = tr.requests
        metrics = {}
        for m in want:
            value = readers[m["name"]].read(tr)
            if value is not None:
                metrics[m["name"]] = dict(value=value, unit=m["unit"])
        dev = device_info(cell, peak)
        dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
        log(json.dumps(dict(spans={k: sum(v) for k, v in tr.spans.items()},
                            launches_counted={k: len(v) for k, v in
                                              tr.bounds.items()},
                            bound_s={k: sum(v) for k, v in
                                     tr.bounds.items()},
                            kernel_s=tr.kernel_s)))
    checks, failed = cell.check(samples)
    correct = failed == 0 and all(v <= lim for v, lim in checks.values())
    result = dict(correct=correct, attempted=attempted,
                  failed=int(failed), metrics=metrics, device=dev)
    if trace:
        result["breakdown"] = dict(
            device_ops=[[k, v] for k, v in tr.device_ops],
            idle_gaps=[[k, v] for k, v in tr.idle_gaps])
    return result, checks
