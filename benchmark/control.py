"""The control of a cell's correctness check: answers that break a guarantee
the configuration states, put where the program's answers go, must read
as not correct.

    python3 -m benchmark.control --workload <cell> --seeds <a,b,c> [--steps n]

For each seed: the cell's set-up, then `steps` answers of the control
(a proof cell: proofs of false statements, `systems.prover.System.run`
with `tamper`; a commitment cell: the reference with every coefficient cut
to 253 bits, `systems.commit.System.control`), judged by the same check as
a run's window. Prints one JSON line per seed with the numbers compared.
The benchmark's own runs never run it.
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys

from .run import HERE, ROOT, load_json


def control_readings(cell: str, seed: int, steps: int, device: str,
                     config_override: dict | None = None) -> dict:
    from .trace import HostPhases

    manifest = load_json(ROOT, "BENCHMARK.json")
    w = {c["name"]: c for c in manifest["workloads"]}[cell]
    config = {**load_json(HERE, "configs", f"{w['config']}.json"), **(config_override or {})}
    traffic = load_json(HERE, "traffic", f"{w['traffic']}.json")
    phases = HostPhases()
    system = importlib.import_module(f"benchmark.systems.{config['system']}").System(
        config, traffic, seed, device, phases)
    if hasattr(system, "control"):
        records = [system.run(i, system.draw(i), phases) for i in range(steps)]
        system.release()
        return system.check(records, want=system.control(records))
    records = [system.run(i, system.draw(i), phases, tamper=True) for i in range(steps)]
    system.release()
    return system.check(records)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--steps", type=int, default=2)
    a = ap.parse_args(argv)
    for seed in (int(s) for s in a.seeds.split(",")):
        found = control_readings(a.workload, seed, a.steps, "cuda")
        print(json.dumps({"workload": a.workload, "seed": seed, "steps": a.steps, "control": found}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
