"""Scaling sweep (BASELINE.json config 5): the sharded MSM at d = 1, 2, 4,
... shards and on a 2 x (d/2) (host, chip) mesh, each point checked against
the unsharded MSM, with times and efficiency against d = 1.

Counterpart of `bench_scaling.py`:

    python -m paillier_halo2_tpu_torch.benches.bench_scaling [log2_points]
        [--device cuda:0] [--shards 8] [--params-dir DIR]

Defaults: 2^14 points (BENCH_MSM_LOG2), up to 8 shards
(BENCH_SCALING_DEVICES). On an unindexed `cuda` with at least that many
cards each shard has a card of its own, which measures scale-out; else
every shard lives on the one device named (an indexed card such as
`cuda:0`, the first card for `cuda`, or the CPU), as the JAX script
provisions eight virtual devices on a one-chip host. There the times
measure the cost of sharding, not scale-out, and the JSON line says so
(`cards`, `note`). The scalars are the script's (`np.random.default_rng(7)`,
four 62-bit draws a scalar, reduced mod r); each route takes its default
window.
"""
from __future__ import annotations

import argparse
import json


def scaling_scalars(k: int, device):
    """`bench_scaling.py`'s scalars as (8, 2^k) limbs."""
    import numpy as np

    from ..ec import host as ech
    from ..ff import field as f

    n = 1 << k
    rng = np.random.default_rng(7)
    scalars = [int(x) % ech.R for x in rng.integers(0, 1 << 62, n).tolist()]
    scalars = [
        (a | (b << 62) | (c << 124) | (d << 186)) % ech.R
        for a, b, c, d in zip(scalars, (int(x) for x in rng.integers(0, 1 << 62, n)),
                              (int(x) for x in rng.integers(0, 1 << 62, n)),
                              (int(x) for x in rng.integers(0, 1 << 62, n)))
    ]
    return f.pack_ints(scalars, device)


def mesh_device(device, shards: int):
    """(the device the meshes are made on, a note): an unindexed `cuda`
    keeps it where there are `shards` cards; otherwise all shards go on
    one device."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        if torch.cuda.device_count() >= shards:
            return "cuda", "one shard a card: scale-out"
        dev = torch.device("cuda", 0)
    where = "one card" if dev.type == "cuda" else "the CPU"
    return str(dev), (f"every shard on {where}: the times measure the cost of sharding, "
                      "not scale-out")


def run(k: int = 14, device="cuda", shards: int = 8, params_dir: str | None = None) -> dict:
    """The sweep; raises where a point differs from the unsharded MSM."""
    from ..mesh import msm as mesh_msm
    from ..mesh.sharding import make_mesh, make_mesh_2d
    from ..msm.pippenger import msm_packed
    from ..plonk.srs import read_or_create_srs
    from . import check_device, log, timed

    name = check_device(device)
    mesh_on, note = mesh_device(device, shards)
    n = 1 << k
    srs = read_or_create_srs(k, device=mesh_on, params_dir=params_dir)
    bases = (srs.g1_px, srs.g1_py, srs.g1_inf)
    sd = scaling_scalars(k, mesh_on)
    log(f"device: {name}; MSM 2^{k}, up to {shards} shards ({note})")
    # the unsharded MSM, on the CPU at the window the sharded route's d = 1
    # takes there; its call also loads the kernels before any point is timed
    window = None if sd.device.type == "cuda" else mesh_msm._unsigned_window_bits(n)
    expected, t_single = timed(lambda: msm_packed(*bases, sd, window), mesh_on)
    log(f"unsharded: {t_single:.4f} s")

    times, cards = {}, {}
    points = [(str(1 << i), make_mesh(1 << i, mesh_on)) for i in range(shards.bit_length())]
    if shards >= 4:
        points.append((f"2x{shards // 2}", make_mesh_2d(2, shards // 2, mesh_on)))
    for label, mesh in points:
        r, times[label] = timed(lambda: mesh_msm.msm_sharded(mesh, *bases, sd), mesh_on)
        cards[label] = mesh.n_cards
        log(f"{label} shard(s) on {mesh.n_cards} card(s): {times[label]:.4f} s "
            f"({n / times[label] / 1e3:.1f} K points/s)")
        if r != expected:
            raise RuntimeError(f"the sharded MSM differs from the unsharded one ({label} shards)")
    base = times["1"]
    eff = {label: base / (t * shards_of(label)) for label, t in times.items()}
    return {"msm_log2": k, "times_s": times, "scaling_efficiency": eff,
            "unsharded_s": t_single, "all_equal": True, "cards": cards, "note": note,
            "device": name}


def shards_of(key: str) -> int:
    """Shards of a sweep point: "4" -> 4, "2x4" -> 8."""
    d = 1
    for part in key.split("x"):
        d *= int(part)
    return d


def main(argv=None, device="cuda") -> dict:
    ap = argparse.ArgumentParser(description="Sharded-MSM scaling sweep")
    ap.add_argument("log2_points", nargs="?", type=int, default=14)
    ap.add_argument("--device", default=device)
    ap.add_argument("--shards", type=int, default=8, help="BENCH_SCALING_DEVICES")
    ap.add_argument("--params-dir", default=None, help="SRS cache (default the repo's params/)")
    a = ap.parse_args(argv)
    out = run(a.log2_points, a.device, a.shards, a.params_dir)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
