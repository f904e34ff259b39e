"""MockProver — vectorized constraint checking over the witness table.

Counterpart of `paillier_halo2_tpu/mock/prover.py:1` (halo2-axiom's
MockProver, SURVEY.md section 2.2): evaluates every gate, lookup, copy and
constant constraint directly on the witness, without committing.

- `mock_prove_host`: numpy and Python ints, the oracle (copied);
- `mock_prove_torch`: the witness packed into an `(8, N)` int32 limb tensor
  and all four families checked by `check_constraints` — index gathers,
  the gate product through K1 (`ff/mulmod.py`: the CUDA kernel on the card,
  its plain version on the CPU), field add/sub and limb compares;
- `mock_prove_chunked`: the streamed route for tables too large for the
  device: gates and lookups in fixed-size row chunks with a 3-row overlap,
  copies and constants on the host over the packed matrix.

All report the violated rows (gates, lookups) and constraint indices
(copies, constants) in the same order, mirroring `expect_satisfied(true)`
(upstream src/paillier.rs:167-170).

Routes: `mock_prove_torch` picks one-shot or chunked before it allocates
anything, and prints its choice. On the card it counts the bytes the
one-shot check holds (`oneshot_bytes`) against `torch.cuda.mem_get_info`;
on the CPU it keeps the JAX package's row threshold. An out-of-memory error
is raised like any other, never retried on the other route.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..ff import field as f
from ..ff.host import FR_MOD
from ..gadgets.context import VirtualTable

SPEC = f.FR
# The JAX package's one-shot limit (`paillier_halo2_tpu/mock/prover.py:95`);
# the route threshold on the CPU.
CHUNK_THRESHOLD_ROWS = 1 << 23
# Index lanes one evaluation of a family takes at once: bounds the gate
# check's temporaries whatever the table's size (the result is the same).
SLICE = 1 << 22
# Device bytes one gate lane may hold at its peak: the four gathered limb
# rows, the K1 operands and outputs, and the int64 temporaries of the plain
# field add and sub (about 650 B), with room to spare.
LANE_BYTES = 1024
_PACK_STEP = 1 << 20


@dataclasses.dataclass
class MockResult:
    satisfied: bool
    gate_failures: np.ndarray  # row indices of violated gate starts
    lookup_failures: np.ndarray
    copy_failures: np.ndarray  # indices into the copy list
    const_failures: np.ndarray

    def assert_satisfied(self) -> None:
        if not self.satisfied:
            raise AssertionError(
                "MockProver: constraint system not satisfied: "
                f"gates@{self.gate_failures[:5]} lookups@{self.lookup_failures[:5]} "
                f"copies@{self.copy_failures[:5]} consts@{self.const_failures[:5]}"
            )


def mock_prove_host(table: VirtualTable, lookup_bits: int) -> MockResult:
    v = table.values
    gate_bad = []
    for s in table.gates:
        s = int(s)
        if (int(v[s]) + int(v[s + 1]) * int(v[s + 2]) - int(v[s + 3])) % FR_MOD != 0:
            gate_bad.append(s)
    bound = 1 << lookup_bits
    lookup_bad = [int(i) for i in table.lookups if not (0 <= int(v[int(i)]) < bound)]
    copy_bad = [
        j
        for j, (a, b) in enumerate(zip(table.copy_a, table.copy_b))
        if int(v[int(a)]) != int(v[int(b)])
    ]
    const_bad = [
        j
        for j, (i, c) in enumerate(zip(table.const_idx, table.const_val))
        if int(v[int(i)]) != int(c) % FR_MOD
    ]
    ok = not (gate_bad or lookup_bad or copy_bad or const_bad)
    return MockResult(
        ok,
        np.array(gate_bad, dtype=np.int64),
        np.array(lookup_bad, dtype=np.int64),
        np.array(copy_bad, dtype=np.int64),
        np.array(const_bad, dtype=np.int64),
    )


# -- the device check --------------------------------------------------------------


def _by_slices(fn, *cols: torch.Tensor) -> torch.Tensor:
    """fn over SLICE-lane slices of the last axis of `cols`, its bool masks
    joined."""
    n = cols[0].shape[-1]
    if n <= SLICE:
        return fn(*cols)
    out = torch.empty(n, dtype=torch.bool, device=cols[0].device)
    for s in range(0, n, SLICE):
        out[s : s + SLICE] = fn(*(c[..., s : s + SLICE] for c in cols))
    return out


def _gates_bad(spec, w: torch.Tensor, gates: torch.Tensor) -> torch.Tensor:
    """w[s] + w[s+1] * w[s+2] != w[s+3] (mod p) for each gate start s."""
    a, b, c, d = (w.index_select(1, gates + k) for k in range(4))
    prod = f.mont_mul(spec, f.to_mont(spec, b), c)  # plain product b*c mod p
    return (f.sub(spec, f.add(spec, a, prod), d) != 0).any(dim=0)


def _lookups_bad(w: torch.Tensor, lookups: torch.Tensor, lookup_bits: int) -> torch.Tensor:
    """value >= 2^lookup_bits <=> a limb above the boundary limb is nonzero,
    or the boundary limb, read unsigned, is at least 2^(lookup_bits % 32)."""
    lv = w.index_select(1, lookups)
    n_full, rem = divmod(lookup_bits, 32)
    ok = (lv[n_full + (1 if rem else 0) :] == 0).all(dim=0)
    if rem:
        ok &= (lv[n_full].to(torch.int64) & 0xFFFFFFFF) < (1 << rem)
    return ~ok


def _pairs_bad(w: torch.Tensor, ia: torch.Tensor, ib: torch.Tensor) -> torch.Tensor:
    return (w.index_select(1, ia) != w.index_select(1, ib)).any(dim=0)


def _consts_bad(w: torch.Tensor, idx: torch.Tensor, limbs: torch.Tensor) -> torch.Tensor:
    return (w.index_select(1, idx) != limbs).any(dim=0)


def check_constraints(spec, w, gates, lookups, copy_a, copy_b, const_idx, const_limbs,
                      lookup_bits: int):
    """All-constraint evaluation on the `(8, N)` int32 witness `w`; returns
    the four violation masks (gates, lookups, copies, constants) as bool
    tensors. Indices are int64 tensors on w's device, `const_limbs` the
    `(8, n_consts)` limbs of the constants mod p. Counterpart of
    `_check_kernel` (`paillier_halo2_tpu/mock/prover.py:73`)."""
    return (
        _by_slices(lambda g: _gates_bad(spec, w, g), gates),
        _by_slices(lambda i: _lookups_bad(w, i, lookup_bits), lookups),
        _by_slices(lambda a, b: _pairs_bad(w, a, b), copy_a, copy_b),
        _by_slices(lambda i, c: _consts_bad(w, i, c), const_idx, const_limbs),
    )


# -- host packing, devices and routes ----------------------------------------------


def pack_witness(vals, out: torch.Tensor) -> torch.Tensor:
    """Object ints below 2^256 -> `out`, a preallocated `(8, len(vals))`
    int32 tensor on any device, filled in steps of 2^20 values (the host
    never holds more than one step's bytes)."""
    for s in range(0, len(vals), _PACK_STEP):
        sub = vals[s : s + _PACK_STEP]
        buf = b"".join(int(v).to_bytes(32, "little") for v in sub)
        limbs = np.frombuffer(buf, np.uint32).reshape(-1, 8).T
        out[:, s : s + len(sub)].copy_(torch.from_numpy(np.ascontiguousarray(limbs).view(np.int32)))
    return out


def require_device(device, who: str) -> torch.device:
    """The torch device a caller asked for; raises for a CUDA device where
    there is none (the caller passes "cpu" to run on the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who}: no CUDA device; pass device='cpu' to run on the CPU")
    return device


def oneshot_bytes(n_rows: int, n_gates: int, n_lookups: int, n_copies: int,
                  n_consts: int) -> int:
    """Device bytes the one-shot check holds: the witness (32 B a row), each
    index (int64) and its mask, the constants' limbs, and one slice of gate
    temporaries."""
    masks = n_gates + n_lookups + n_copies + n_consts
    indices = 8 * (masks + n_copies)
    widest = min(max(n_gates, n_lookups, n_copies, n_consts, 1), SLICE)
    return 32 * n_rows + indices + masks + 32 * n_consts + widest * LANE_BYTES


def plan_route(table: VirtualTable, device: torch.device) -> tuple[str, str]:
    """("one-shot" | "chunked", why) for this table on `device`, decided
    before anything is allocated."""
    n = table.n_rows
    if device.type == "cuda":
        need = oneshot_bytes(n, len(table.gates), len(table.lookups), len(table.copy_a),
                             len(table.const_idx))
        free = torch.cuda.mem_get_info(device)[0]
        route = "one-shot" if need <= free else "chunked"
        return route, f"needs {need / 2**30:.3f} GiB of {free / 2**30:.3f} GiB free"
    route = "one-shot" if n <= CHUNK_THRESHOLD_ROWS else "chunked"
    return route, f"{n} rows against the CPU threshold of {CHUNK_THRESHOLD_ROWS}"


class _Clock:
    """Milliseconds of device work: CUDA events on the card (read after a
    synchronise), the host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def __enter__(self):
        if self.cuda:
            self.start = torch.cuda.Event(enable_timing=True)
            self.end = torch.cuda.Event(enable_timing=True)
            self.start.record()
        else:
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.cuda:
            self.end.record()
            self.end.synchronize()
            self.ms = self.start.elapsed_time(self.end)
        else:
            self.ms = (time.perf_counter() - self.t0) * 1e3


def index_tensor(x, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.int64)).to(device)


def _counts(table: VirtualTable) -> dict:
    return {"rows": table.n_rows, "gates": len(table.gates), "lookups": len(table.lookups),
            "copies": len(table.copy_a), "consts": len(table.const_idx)}


# -- the two routes ----------------------------------------------------------------


def mock_prove_torch(table: VirtualTable, lookup_bits: int, device="cuda",
                     stats: dict | None = None) -> MockResult:
    """Counterpart of `mock_prove_jax` (`paillier_halo2_tpu/mock/prover.py:199`):
    the whole witness on `device` at once, or `mock_prove_chunked` where
    `plan_route` says it does not fit. `stats`, if given, receives the
    route, the table's counts, the pack seconds and the check's device
    milliseconds."""
    device = require_device(device, "mock_prove_torch")
    route, why = plan_route(table, device)
    print(f"mock_prove_torch: {route} route on {device} ({why})", flush=True)
    if route == "chunked":
        if stats is not None:
            stats["why"] = why
        return mock_prove_chunked(table, lookup_bits, device=device, stats=stats)
    t0 = time.perf_counter()
    w = pack_witness(table.values, torch.empty((8, table.n_rows), dtype=torch.int32, device=device))
    const_limbs = f.pack_ints([int(x) % FR_MOD for x in table.const_val], device)

    def nz(x):  # avoid zero-length gathers (pad with row 0 self-compare)
        return index_tensor(x if len(x) else np.zeros(1, dtype=np.int64), device)

    if not len(table.const_val):
        const_limbs = torch.zeros((8, 1), dtype=torch.int32, device=device)
    args = (nz(table.gates), nz(table.lookups), nz(table.copy_a), nz(table.copy_b),
            nz(table.const_idx), const_limbs)
    pack_s = time.perf_counter() - t0
    with _Clock(device) as clock:
        masks = [m.cpu().numpy() for m in check_constraints(SPEC, w, *args, lookup_bits)]
    gate_bad, lookup_bad, copy_bad, const_bad = masks

    def fails(mask, src, n_real):
        mask = mask[:n_real]
        return np.asarray(src[:n_real])[mask] if n_real else np.zeros(0, dtype=np.int64)

    gf = fails(gate_bad, table.gates, len(table.gates))
    lf = fails(lookup_bad, table.lookups, len(table.lookups))
    cf = (
        np.nonzero(copy_bad[: len(table.copy_a)])[0]
        if len(table.copy_a)
        else np.zeros(0, dtype=np.int64)
    )
    kf = (
        np.nonzero(const_bad[: len(table.const_idx)])[0]
        if len(table.const_idx)
        else np.zeros(0, dtype=np.int64)
    )
    if stats is not None:
        stats.update(_counts(table), route=route, why=why, pack_s=pack_s, check_ms=clock.ms)
    ok = not (len(gf) or len(lf) or len(cf) or len(kf))
    return MockResult(ok, gf, lf, cf, kf)


def mock_prove_chunked(table: VirtualTable, lookup_bits: int, chunk_rows: int = 1 << 22,
                       device="cuda", stats: dict | None = None) -> MockResult:
    """Counterpart of `paillier_halo2_tpu/mock/prover.py:129`: the streamed
    MockProver for tables too large to hold on the device at once (the
    2048-bit geometry of BASELINE.json config 1 has about 319 M virtual
    rows). The witness lives on the host as an `(8, N)` int32 matrix; gates
    and lookups stream through `device` in fixed-size chunks (a gate window
    is 4 consecutive rows, so a 3-row overlap keeps every window local: a
    gate that starts in the overlap belongs to the next chunk); copy and
    constant equalities, compares of rows at any distance, run on the host
    over the same matrix."""
    device = require_device(device, "mock_prove_chunked")
    n = table.n_rows
    t0 = time.perf_counter()
    wb = pack_witness(table.values, torch.empty((8, n), dtype=torch.int32))
    pack_s = time.perf_counter() - t0

    # ---- copies + constants (host, sliced gathers) -------------------------
    t0 = time.perf_counter()
    neq = _by_slices(lambda a, b: _pairs_bad(wb, a, b), index_tensor(table.copy_a, "cpu"),
                     index_tensor(table.copy_b, "cpu")).numpy()
    copy_bad = np.nonzero(neq)[0].astype(np.int64)
    const_bad = np.zeros(0, dtype=np.int64)
    if len(table.const_idx):
        cv = f.pack_ints([int(x) % FR_MOD for x in table.const_val], "cpu")
        neq = _consts_bad(wb, index_tensor(table.const_idx, "cpu"), cv).numpy()
        const_bad = np.nonzero(neq)[0].astype(np.int64)
    host_s = time.perf_counter() - t0

    # ---- gates + lookups (device, fixed-size chunks) -----------------------
    gates = np.asarray(table.gates, dtype=np.int64)
    lookups = np.asarray(table.lookups, dtype=np.int64)
    gate_fail, lookup_fail = [], []
    # Exact per-chunk caps from the real index densities (every chunk has the
    # same shapes; padding gathers row 0 and is filtered after).
    starts = list(range(0, n, chunk_rows))
    g_chunk = np.minimum(gates // chunk_rows, len(starts) - 1) if len(gates) else gates
    l_chunk = np.minimum(lookups // chunk_rows, len(starts) - 1) if len(lookups) else lookups
    g_cap = int(np.bincount(g_chunk, minlength=len(starts)).max()) if len(gates) else 1
    l_cap = int(np.bincount(l_chunk, minlength=len(starts)).max()) if len(lookups) else 1
    w8 = torch.empty((8, chunk_rows + 3), dtype=torch.int32, device=device)
    check_ms = 0.0
    for start in starts:
        end = min(start + chunk_rows + 3, n)
        rows = end - start
        g_sel = gates[(gates >= start) & (gates + 3 < start + chunk_rows + 3)]
        # gates starting in the overlap belong to the NEXT chunk
        g_sel = g_sel[g_sel < start + chunk_rows]
        l_sel = lookups[(lookups >= start) & (lookups < start + chunk_rows)]
        g_loc = np.zeros(g_cap, dtype=np.int64)
        g_loc[: len(g_sel)] = g_sel - start
        l_loc = np.zeros(l_cap, dtype=np.int64)
        l_loc[: len(l_sel)] = l_sel - start
        # rows past `rows` keep stale values: no real index reaches them
        # (every gate window ends below n) and padding reads row 0
        w8[:, :rows].copy_(wb[:, start:end])
        g_dev, l_dev = index_tensor(g_loc, device), index_tensor(l_loc, device)
        with _Clock(device) as clock:
            gb = _by_slices(lambda g: _gates_bad(SPEC, w8, g), g_dev).cpu().numpy()
            lb = _by_slices(lambda i: _lookups_bad(w8, i, lookup_bits), l_dev).cpu().numpy()
        check_ms += clock.ms
        gate_fail.extend(g_sel[gb[: len(g_sel)]].tolist())
        lookup_fail.extend(l_sel[lb[: len(l_sel)]].tolist())

    gf = np.array(gate_fail, dtype=np.int64)
    lf = np.array(lookup_fail, dtype=np.int64)
    if stats is not None:
        stats.update(_counts(table), route="chunked", chunks=len(starts), chunk_rows=chunk_rows,
                     pack_s=pack_s, check_ms=check_ms, host_s=host_s)
    ok = not (len(gf) or len(lf) or len(copy_bad) or len(const_bad))
    return MockResult(ok, gf, lf, copy_bad, const_bad)
