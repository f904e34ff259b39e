"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Everything particular to a cell is data found
by name: the cell in `BENCHMARK.json`, its configuration in
`benchmark/configs/<config>.json` (whose `system` names the module in
`benchmark/systems/` that drives the program), its traffic in
`benchmark/traffic/<traffic>.json`, and each metric's reader in
`benchmark/metrics/<metric>.py` (or, for a name with a dot, the reader of
the part before the dot, where the whole name has none).

A run: set-up (the system's, warm-up included) is timed from process
start; then steps run back to back until `--seconds` have passed, each
step's input drawn (`system.draw(i)`) and proved or committed
(`system.run`) and its answer kept; with `--trace 1` a bounded number of
further steps, their inputs drawn beforehand, run under one profiler
session. The program's state is then freed, the
reference checks every answer of the window, and the last line on stdout
is one JSON object; the numbers compared, each beside its limit, are the
last lines on stderr.
"""
from __future__ import annotations

import time

T0 = time.monotonic()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "paillier_halo2_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_json(*parts: str) -> dict:
    with open(os.path.join(*parts)) as fh:
        return json.load(fh)


def load_reader(name: str):
    """The reader of metric `name`: `benchmark/metrics/<name>.py`, or that
    of the part of the name before its first dot."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    if not os.path.exists(path):
        path = os.path.join(HERE, "metrics", f"{name.split('.')[0]}.py")
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics." + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(manifest: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a run of `cell` reports: its end-to-end metrics, or with
    `trace` the per-layer ones that list it."""
    if trace:
        return [m for m in manifest["per_layer"] if cell in m["workloads"]]
    return [m for m in manifest["end_to_end"] if cell in m.get("workloads", [cell])]


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class GcClock:
    """Seconds the garbage collector ran, and its collections, while open."""

    def __init__(self):
        self.seconds, self.count, self._t0 = 0.0, 0, 0.0

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t0 = time.perf_counter()
        else:
            self.seconds += time.perf_counter() - self._t0
            self.count += 1


def loop_ms(reps: int = 5) -> list[float]:
    """Milliseconds of a fixed pure-Python loop, `reps` times: the host
    CPU's speed of the moment, which the cells' host-bound steps follow."""
    out = []
    for _ in range(reps):
        t, x = time.perf_counter(), 0
        for j in range(200_000):
            x += j * j
        out.append((time.perf_counter() - t) * 1e3)
    return out


def power_limit_w():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=20)
        return float(out.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def main(argv=None, device: str | None = None, patch=None, config_override: dict | None = None) -> int:
    """Run one cell; returns the exit code. For tests only: `device` skips
    the look for a card and runs there, `patch(system)` may break the timed
    path after set-up, `config_override` runs a cell at another size."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)

    manifest_path = os.path.join(ROOT, "BENCHMARK.json")
    manifest = load_json(manifest_path)
    cells = {w["name"]: w for w in manifest["workloads"]}
    if a.workload not in cells:
        log(f"no workload {a.workload!r} in {manifest_path}")
        return 2
    cell = cells[a.workload]
    config = {**load_json(HERE, "configs", f"{cell['config']}.json"), **(config_override or {})}
    traffic = load_json(HERE, "traffic", f"{cell['traffic']}.json")
    metrics = cell_metrics(manifest, a.workload, bool(a.trace))

    build = os.path.join(ROOT, "build")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")

    import torch

    from . import trace as tracing

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            have = torch.cuda.device_count() if torch.cuda.is_available() else 0
            log(f"{a.workload} needs {cell['chips']} CUDA device(s); found {have}")
            return 1
        device = "cuda"
    on_card = torch.device(device).type == "cuda"
    system_mod = importlib.import_module(f"benchmark.systems.{config['system']}")
    phases = tracing.HostPhases()

    def sync():
        if on_card:
            torch.cuda.synchronize()

    if on_card:
        torch.cuda.reset_peak_memory_stats()
    system = system_mod.System(config, traffic, a.seed, device, phases)
    if patch is not None:
        patch(system)
    sync()
    setup_s = time.monotonic() - T0
    log(f"{a.workload}: set-up {setup_s:.3f}s; window of {a.seconds}s")

    records, failed, ends = [], 0, []
    gc_clock = GcClock()
    gc.callbacks.append(gc_clock)
    cpu_start = time.process_time()
    t_start = time.perf_counter()
    while True:
        try:
            i = len(records)
            records.append(system.run(i, system.draw(i), phases))
        except Exception:  # a failed step is counted and reported, and the window goes on
            traceback.print_exc()
            records.append(None)
            failed += 1
        ends.append(time.perf_counter())
        if ends[-1] - t_start >= a.seconds:
            break
    sync()
    elapsed = time.perf_counter() - t_start
    cpu_s = time.process_time() - cpu_start
    gc.callbacks.remove(gc_clock)
    steps_s = [t1 - t0 for t0, t1 in zip([t_start] + ends, ends)]
    by_size = sorted(steps_s)
    log(f"window: {len(records)} steps in {elapsed:.3f}s; a step {by_size[0]:.4f} / "
        f"{by_size[len(by_size) // 2]:.4f} / {by_size[-1]:.4f}s (least / median / most)")
    if len(steps_s) <= 64:
        log("steps in order: " + " ".join(f"{t:.3f}" for t in steps_s))
    log(f"host: process CPU {cpu_s:.3f}s in the window; garbage collector {gc_clock.seconds:.4f}s "
        f"in {gc_clock.count} collections; a fixed Python loop after it "
        + " ".join(f"{t:.2f}" for t in loop_ms()) + " ms")
    peak = torch.cuda.max_memory_allocated() if on_card else None
    spans = {k: list(v) for k, v in system.spans.items()}

    trace = None
    if a.trace and on_card:
        n = traffic["profiled_steps"]
        inputs = [(10 ** 6 + j, system.draw(10 ** 6 + j)) for j in range(n)]
        sync()
        trace = tracing.profiled(lambda: [system.run(i, x, phases) for i, x in inputs], n, phases)
    done = len(records) - failed
    obs = {"setup_s": setup_s, "window": {"seconds": elapsed, "steps": done,
                                          "work": done * system.work_per_step},
           "spans": spans, "trace": trace, "inputs": system.inputs}
    values = {}
    for m in metrics:
        v = load_reader(m["name"])(obs)
        if v is not None and (on_card or m["source"] == "host_clock"):
            values[m["name"]] = {"value": v, "unit": m["unit"]}

    system.release()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    found = system.check(records)
    log(f"reference: {time.perf_counter() - t_ref:.3f}s over {len(records)} steps")
    checks = {name: {"value": v, "limit": 0} for name, v in found.items()}
    bad = forbidden_modules()
    if bad:
        log(f"forbidden modules loaded in the measuring process: {', '.join(bad)}")
        return 1

    result = {
        "correct": all(c["value"] <= c["limit"] for c in checks.values()),
        "attempted": len(records),
        "failed": failed,
        "metrics": values,
        "device": {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                   "count": cell["chips"] if on_card else 0,
                   "memory_peak_bytes": peak,
                   "power_limit_w": power_limit_w() if on_card else None},
    }
    if trace is not None:
        result["device"].update(busy_s=trace["busy_s"], window_s=trace["window_s"])
        result["breakdown"] = {"device_ops": trace["device_ops"], "idle_gaps": trace["idle_gaps"]}
    result["checks"] = checks
    print(json.dumps(result), flush=True)
    for name, c in checks.items():
        log(f"check {name}: {c['value']} (limit {c['limit']})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
