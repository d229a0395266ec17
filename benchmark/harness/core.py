"""One run of one cell: set-up, the measured window or the traced stretch,
the judgement of the answers, and the result line.

A run:

1. resolves the cell (harness/cells.py) and makes its victims from
   ``--seed`` (harness/traffic.py, the configuration's reference);
2. sets up the entry (loading or building the kernels, capturing a model)
   and serves ``warmup`` requests: every shape of the window, warm;
3. with ``--trace 0`` serves requests in a closed loop of one client until
   ``--seconds`` have passed, timing each on the host clock; with
   ``--trace 1`` serves ``trace_requests`` requests under ``torch.profiler``
   instead, recording the solver's phases and the kernel launches;
4. reads the peak device memory, frees the program's state and judges every
   answer of the window with the reference, each number against its limit;
5. fails, printing no result, if a forbidden module (harness/guard.py) was
   loaded; otherwise prints the numbers compared as the last lines of
   standard error and the result as the last line of standard output.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field

from . import cells, guard, stats, trace
from .traffic import VictimStream

WINDOW_SPAN = "bench.window"
REQUEST_SPAN = "bench.request"


@dataclass
class Request:
    seconds: float  # the benchmark's span around the call
    phases: dict  # the solver's phases recorded in it: name -> seconds


@dataclass
class RunContext:
    """What the metric readers (benchmark/metrics/) read."""

    setup_s: float
    kind: str
    shape: dict
    latencies_s: list = field(default_factory=list)
    answered: int = 0
    window_s: float = 0.0
    requests: list = field(default_factory=list)  # traced requests
    launches: dict | None = None  # kernel launches over the traced requests
    trace: trace.TraceData | None = None


def _sync(device: str) -> None:
    if str(device).startswith("cuda"):
        import torch

        torch.cuda.synchronize()


def _program_phases() -> dict:
    from gf2bv_tpu_torch.utils import profiling

    return {k: v["total_s"] for k, v in profiling.phase_report().items()}


def _program_launches() -> dict:
    from gf2bv_tpu_torch.ops import _cuda

    return dict(_cuda.LAUNCHES)


def power_limit() -> str | None:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return res.stdout.strip().splitlines()[0] if res.stdout.strip() else None


def _serve(solve, victim, failures: list):
    try:
        return solve(victim.observed)
    except Exception as exc:  # a request that raises is a failed request
        failures.append(f"{type(exc).__name__}: {exc}")
        return None


def run_cell(cell: cells.Cell, seed: int, seconds: float, traced: bool, device: str,
             t0: float, control: bool = False) -> tuple[dict, dict]:
    """Run the cell once; returns (the result object, the numbers compared
    as name -> (value, limit))."""
    import torch

    traffic = cell.traffic
    stream = VictimStream(cell.reference, cell.config, traffic, seed)
    served = traffic["trace_requests"] if traced else math.ceil(seconds * traffic["victims_per_s"])
    stream.make(traffic["warmup"] + served + (1 if traced else 0))
    solve = cell.entry.setup(cell.config, traffic, device, control=control)
    for _ in range(traffic["warmup"]):
        if solve(stream.next().observed) is None:
            raise RuntimeError("a warm-up request found no solution")
    cuda = str(device).startswith("cuda")
    if traced:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        with profile(activities=activities):  # the profiler's own start-up
            solve(stream.next().observed)
            _sync(device)
    _sync(device)
    ctx = RunContext(setup_s=time.perf_counter() - t0,
                     kind=torch.cuda.get_device_name() if cuda else "cpu",
                     shape=cell.reference.shape(cell.config, traffic))
    victims, answers, failures = [], [], []
    if traced:
        _traced_stretch(ctx, solve, stream, traffic["trace_requests"], device, victims, answers,
                        failures, activities)
    else:
        start = time.perf_counter()
        while True:
            v = stream.next()
            t = time.perf_counter()
            a = _serve(solve, v, failures)
            end = time.perf_counter()
            ctx.latencies_s.append(end - t)
            victims.append(v)
            answers.append(a)
            if end - start >= seconds:
                break
        ctx.window_s = end - start
    ctx.answered = sum(a is not None for a in answers)
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    del solve
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t_judge = time.perf_counter()
    values = cell.reference.judge(cell.config, traffic, victims, answers)
    t_judged = time.perf_counter()
    numbers = {k: (values[k], lim) for k, lim in cell.reference.LIMITS.items()}
    correct = all(v <= lim for v, lim in numbers.values())
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = m.reader.read(ctx)
        if value is not None:
            metrics[m.name] = {"value": float(value), "unit": m.unit}
    dev = {"platform": "gpu" if cuda else "cpu", "kind": ctx.kind,
           "count": cell.chips if cuda else 0, "memory_peak_bytes": int(memory_peak)}
    result = {"correct": correct, "attempted": len(answers), "failed": len(failures),
              "metrics": metrics, "device": dev}
    if traced and ctx.trace is not None:
        w = ctx.trace.window
        dev["busy_s"] = trace.busy_us(ctx.trace.device, w) / 1e6
        dev["window_s"] = (w.end - w.start) / 1e6
        result["breakdown"] = {
            "device_ops": [[name, us / 1e6] for us, name, _ in ctx.trace.rows[:10]],
            "idle_gaps": [[k, us / 1e6] for k, us in trace.top(trace.idle_by_host(ctx.trace))],
        }
    print(f"set-up {ctx.setup_s:.2f} s, judge {t_judged - t_judge:.2f} s", file=sys.stderr)
    if ctx.latencies_s:
        lat = sorted(ctx.latencies_s)
        print("latency ms: min {:.2f} median {:.2f} p95 {:.2f} max {:.2f} over {} requests".format(
            1000 * lat[0], 1000 * stats.percentile(lat, 50), 1000 * stats.percentile(lat, 95),
            1000 * lat[-1], len(lat)), file=sys.stderr)
    if failures:
        print(f"{len(failures)} failed requests; the first: {failures[0]}", file=sys.stderr)
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in numbers.items()}
    return result, numbers


def _traced_stretch(ctx, solve, stream, count, device, victims, answers, failures, activities):
    from torch.profiler import profile, record_function

    launches0 = _program_launches()
    with profile(activities=activities) as prof:
        with record_function(WINDOW_SPAN):
            for _ in range(count):
                v = stream.next()
                before = _program_phases()
                with record_function(REQUEST_SPAN):
                    t = time.perf_counter()
                    a = _serve(solve, v, failures)
                    end = time.perf_counter()
                after = _program_phases()
                phases = {k: s - before.get(k, 0.0) for k, s in after.items()
                          if s - before.get(k, 0.0) > 0}
                ctx.requests.append(Request(end - t, phases))
                victims.append(v)
                answers.append(a)
            _sync(device)
    launches1 = _program_launches()
    ctx.launches = {k: launches1[k] - launches0.get(k, 0) for k in launches1}
    t = time.perf_counter()
    ctx.trace = trace.collect(prof, WINDOW_SPAN)
    print(f"trace read in {time.perf_counter() - t:.2f} s", file=sys.stderr)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Run one cell of the benchmark once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, t0: float | None = None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    args = parse_args(argv)
    cell = cells.resolve(cells.load_benchmark(), args.workload)
    # every cache of the program inside the checkout, at fixed paths
    build = cells.ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, numbers = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", t0)
    bad = guard.forbidden_loaded()
    if bad:
        print(f"forbidden modules loaded in the run: {', '.join(bad)}", file=sys.stderr)
        return 3
    card = power_limit()
    if card:
        print(f"card: {card}", file=sys.stderr)
    for k, (v, lim) in numbers.items():
        print(f"check {k} {v} limit {lim}", file=sys.stderr)
    print(json.dumps(result))
    return 0
