"""Virtual constraint-synthesis arena (copy of paillier_halo2_tpu/gadgets/context.py:1)
— re-design of halo2-base's
`Context` / `SinglePhaseCoreManager` (SURVEY.md section 2.2).

The reference records virtual advice cells one at a time from Rust closures.
Here, synthesis is *vectorized*: every gadget op appends a whole block of rows
(numpy arrays) in O(1) Python calls, so circuit synthesis cost scales with the
number of gadget ops, not the number of cells. Witness values are Python ints
(arbitrary precision, mod Fr) held in object arrays; the finalized table is
later packed into 8-bit digit vectors for device-side constraint evaluation
and proving.

Gate shape (vertical flex gate, one advice column per thread, matching
halo2-base's custom gate): for each gate start row i,
    w[i] + w[i+1] * w[i+2] == w[i+3]   (mod Fr)
Copy constraints assert cell equality; constant constraints pin cells to fixed
values; lookup tags assert membership in the [0, 2^lookup_bits) range table.

Host-only module of the PyTorch port, copied from
`paillier_halo2_tpu/gadgets/context.py:1`; it imports neither torch nor jax.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable

import numpy as np

from ..ff import host as ff_host

FR_MOD = ff_host.FR_MOD


def _to_object_array(vals) -> np.ndarray:
    if isinstance(vals, np.ndarray) and vals.dtype == object:
        return vals
    arr = np.empty(len(vals), dtype=object)
    for i, v in enumerate(vals):
        arr[i] = int(v)
    return arr


@dataclasses.dataclass
class Cells:
    """A vector of assigned cells: global row indices + witness values.

    The Python-facing handle gadget ops pass around — analogous to a slice of
    `AssignedValue`s in halo2-base. `idx` and `val` always have equal length.
    """

    idx: np.ndarray  # int64 (m,)
    val: np.ndarray  # object (m,) Python ints in [0, FR_MOD)

    def __len__(self) -> int:
        return len(self.idx)

    def __getitem__(self, sl) -> "Cells":
        if isinstance(sl, int):
            sl = slice(sl, sl + 1)
        return Cells(self.idx[sl], self.val[sl])

    def concat(self, other: "Cells") -> "Cells":
        return Cells(
            np.concatenate([self.idx, other.idx]),
            np.concatenate([self.val, other.val]),
        )

    def broadcast_to(self, m: int) -> "Cells":
        assert len(self) == 1
        return Cells(np.repeat(self.idx, m), np.repeat(self.val, m))

    def ints(self) -> list[int]:
        return [int(v) for v in self.val]


class Context:
    """Append-only virtual table builder (single phase, single virtual thread)."""

    def __init__(self) -> None:
        self._value_chunks: list[np.ndarray] = []
        self._n_rows = 0
        self._gate_chunks: list[np.ndarray] = []  # gate start rows
        self._copy_a: list[np.ndarray] = []
        self._copy_b: list[np.ndarray] = []
        self._const_idx: list[np.ndarray] = []
        self._const_val: list[np.ndarray] = []
        self._lookup_chunks: list[np.ndarray] = []  # cells tagged for range lookup
        self._public_chunks: list[np.ndarray] = []  # cells exposed as public inputs
        self._const_cache: dict[int, int] = {}  # value -> canonical cell idx
        self._zero_cell: Cells | None = None

    # -- raw appends ---------------------------------------------------------

    def append_rows(self, values: np.ndarray) -> int:
        """Append a block of witness rows; returns the start row index."""
        values = _to_object_array(values)
        start = self._n_rows
        self._value_chunks.append(values)
        self._n_rows += len(values)
        return start

    def add_gates(self, starts: np.ndarray) -> None:
        self._gate_chunks.append(np.asarray(starts, dtype=np.int64))

    def add_copies(self, a_idx: np.ndarray, b_idx: np.ndarray) -> None:
        a_idx = np.asarray(a_idx, dtype=np.int64)
        b_idx = np.asarray(b_idx, dtype=np.int64)
        assert a_idx.shape == b_idx.shape
        if len(a_idx):
            self._copy_a.append(a_idx)
            self._copy_b.append(b_idx)

    def add_constants(self, idx: np.ndarray, vals) -> None:
        idx = np.asarray(idx, dtype=np.int64)
        if len(idx):
            self._const_idx.append(idx)
            self._const_val.append(_to_object_array(vals))

    def add_lookups(self, idx: np.ndarray) -> None:
        idx = np.asarray(idx, dtype=np.int64)
        if len(idx):
            self._lookup_chunks.append(idx)

    def expose_public(self, cells: "Cells") -> None:
        """Expose cells as PUBLIC INPUTS (an instance column): their values
        become part of the statement — the verifier receives them alongside
        the proof and re-derives the instance evaluation itself, so a proof
        only verifies against the exact exposed values. Order of exposure =
        order in the instance column. (halo2's instance columns [dep]; the
        reference's own tests use none, SURVEY.md section 2.2.)"""
        self._public_chunks.append(np.asarray(cells.idx, dtype=np.int64))

    # -- cell creation -------------------------------------------------------

    def load_witness(self, vals) -> Cells:
        """Unconstrained advice cells (constrained later by gates/copies)."""
        vals = _to_object_array(vals)
        start = self.append_rows(vals)
        return Cells(np.arange(start, start + len(vals), dtype=np.int64), vals)

    def load_constants(self, vals) -> Cells:
        """Cells pinned to fixed values, deduped via the constant cache."""
        vals = _to_object_array(vals)
        idx = np.empty(len(vals), dtype=np.int64)
        new_vals, new_pos = [], []
        for i, v in enumerate(vals):
            v = int(v) % FR_MOD
            cached = self._const_cache.get(v)
            if cached is None:
                new_pos.append(i)
                new_vals.append(v)
            else:
                idx[i] = cached
        if new_vals:
            start = self.append_rows(_to_object_array(new_vals))
            arr = np.arange(start, start + len(new_vals), dtype=np.int64)
            self.add_constants(arr, new_vals)
            for p, v, j in zip(new_pos, new_vals, arr):
                self._const_cache[v] = int(j)
                idx[p] = j
        return Cells(idx, np.array([v % FR_MOD for v in vals], dtype=object))

    def load_zero(self) -> Cells:
        """Mirror of ctx.load_zero() (upstream src/paillier.rs:47)."""
        if self._zero_cell is None:
            self._zero_cell = self.load_constants([0])
        return self._zero_cell

    # -- finalize ------------------------------------------------------------

    @property
    def n_rows(self) -> int:
        return self._n_rows

    def finalize(self) -> "VirtualTable":
        def cat(chunks, dtype=None):
            if not chunks:
                return np.zeros(0, dtype=dtype or np.int64)
            return np.concatenate(chunks)

        return VirtualTable(
            values=cat(self._value_chunks, object),
            gates=cat(self._gate_chunks),
            copy_a=cat(self._copy_a),
            copy_b=cat(self._copy_b),
            const_idx=cat(self._const_idx),
            const_val=cat(self._const_val, object),
            lookups=cat(self._lookup_chunks),
            publics=cat(self._public_chunks),
        )


@dataclasses.dataclass
class VirtualTable:
    """Finalized single-column virtual circuit, pre column-assignment.

    The input both to the mock prover (SURVEY.md section 2.2 "MockProver") and
    to the real prover's column assignment / config auto-sizing step
    (config_params dry run, upstream src/bench.rs:173).
    """

    values: np.ndarray  # object (n_rows,)
    gates: np.ndarray  # int64 (n_gates,) gate start rows
    copy_a: np.ndarray  # int64 (n_copies,)
    copy_b: np.ndarray  # int64 (n_copies,)
    const_idx: np.ndarray  # int64 (n_consts,)
    const_val: np.ndarray  # object (n_consts,)
    lookups: np.ndarray  # int64 (n_lookups,)
    # cells exposed as public inputs, in instance-column order (may be empty)
    publics: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, dtype=np.int64)
    )

    @property
    def n_rows(self) -> int:
        return len(self.values)

    def public_values(self) -> list[int]:
        """The statement's public inputs (instance values), in column order."""
        return [int(self.values[i]) for i in self.publics]


def row_offsets(tables: Iterable[VirtualTable]) -> list[int]:
    """Each table's first row in the merge of `tables`, in order."""
    base, offsets = 0, []
    for t in tables:
        offsets.append(base)
        base += t.n_rows
    return offsets


def merge_tables(tables: Iterable[VirtualTable]) -> VirtualTable:
    """Concatenate independently synthesized virtual tables into one circuit,
    rebasing every row index by the preceding tables' row counts
    (`row_offsets`).

    This is the assignment-time merge of a Context pool (halo2-base's
    SinglePhaseCoreManager collects per-thread Contexts the same way,
    upstream src/bench.rs:3,38). Duplicate constants across
    sub-tables collapse later in layout's fixed-column dedup, so the merged
    circuit is equivalent to serial synthesis up to per-context cached cells
    (e.g. each sub-context carries its own zero cell)."""
    tables = list(tables)
    offsets = row_offsets(tables)

    def cat(field: str, dtype=None, rebase: bool = False):
        chunks = []
        for t, off in zip(tables, offsets):
            arr = getattr(t, field)
            chunks.append(arr + off if rebase and len(arr) else arr)
        if not chunks:
            return np.zeros(0, dtype=dtype or np.int64)
        return np.concatenate(chunks)

    return VirtualTable(
        values=cat("values", object),
        gates=cat("gates", rebase=True),
        copy_a=cat("copy_a", rebase=True),
        copy_b=cat("copy_b", rebase=True),
        const_idx=cat("const_idx", rebase=True),
        const_val=cat("const_val", object),
        lookups=cat("lookups", rebase=True),
        publics=cat("publics", rebase=True),
    )


def _synth_instance(fn, idx):
    """fn(ctx, idx) in a fresh Context: (the finalized table, the row
    indices of the Cells fn returned, or None where it returned none)."""
    ctx = Context()
    out = fn(ctx, idx)
    return ctx.finalize(), (out.idx.copy() if isinstance(out, Cells) else None)


def _synth_worker_spawn(args):
    """Spawn-pool worker: fn ships via pickle (must be a top-level callable
    or a functools.partial of one). The child is a FRESH interpreter; the
    gadget layer runs on host ints and touches no torch tensor. Returns
    (the worker's pid, the instance's table, its returned cell indices)."""
    import os

    fn, idx = args
    return (os.getpid(), *_synth_instance(fn, idx))


class SynthPool:
    """A pool of spawn workers that `synth_parallel(..., pool=)` reuses from
    call to call, so that a prover synthesizing batch after batch starts
    its interpreters once. `SynthPool(n_workers)`; `close()` (or leave its
    `with` block) ends the workers. `spawn_s` is the seconds its start took.
    A pool whose wait failed is closed, and keeps the failure in `error`:
    every later call that is given it synthesizes serially and reports that
    error."""

    def __init__(self, n_workers: int):
        import multiprocessing as mp
        import time

        if n_workers < 2:
            raise ValueError(f"a pool needs at least 2 workers, not {n_workers}")
        t0 = time.perf_counter()
        self.n_workers = n_workers
        self.error: str | None = None
        self._pool = mp.get_context("spawn").Pool(n_workers)
        self.spawn_s = time.perf_counter() - t0

    def map(self, args: list, timeout: float) -> list:
        if self._pool is None:
            raise RuntimeError(self.error or "the pool is closed")
        return self._pool.map_async(_synth_worker_spawn, args, chunksize=1).get(timeout=timeout)

    def fail(self, error: str) -> None:
        self.error = error
        self.close()

    def close(self) -> None:
        if self._pool is not None:
            self._pool.terminate()
            self._pool.join()
            self._pool = None

    def __enter__(self) -> "SynthPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class SinglePhaseCoreManager:
    """Witness pool — the analog of halo2-base's multithreaded
    SinglePhaseCoreManager (upstream src/bench.rs:3,38: `pool.main()`
    hands the synthesis closure its Context; the pool's Contexts are merged
    at assignment time).

    Two modes:
    - `main()` returns the single Context (synthesis here is vectorized
      block-appends, so one Context covers the reference's consumer pattern
      `paillier_enc_test(pool.main(), range, ...)`);
    - `synth_parallel(fn, n)` shards witness generation across worker
      PROCESSES (Python ints do not parallelize under the GIL the way the
      reference's rayon threads do): fn(ctx, i) synthesizes instance i into
      its own Context in a spawned worker, and the resulting tables merge via
      `merge_tables`. Deterministic: the merge order is the instance order,
      independent of worker scheduling.
    """

    def __init__(self) -> None:
        self._ctx = Context()

    def main(self) -> Context:
        return self._ctx

    def finalize(self) -> VirtualTable:
        return self._ctx.finalize()

    @staticmethod
    def synth_parallel(fn, n_instances: int, n_workers: int | None = None,
                       stats: dict | None = None, pool: SynthPool | None = None,
                       outputs: list | None = None) -> VirtualTable:
        """Run fn(ctx, i) for i in range(n_instances) across SPAWN worker
        processes; merge the per-instance tables in instance order. Workers
        must not touch torch (pure host-int synthesis).

        fork() after torch has started its thread pools (or CUDA) is unsafe,
        so the pool always spawns fresh interpreters: a pool of its own for
        the call, or the caller's kept `pool` (then `n_workers` is the
        pool's). Spawn requires fn to be picklable (a top-level function or
        functools.partial of one); unpicklable closures run serially. The
        pool wait is bounded: on timeout the pool is torn down and synthesis
        runs serially in-process — slower, never hung.

        `outputs`, where given, receives one entry per instance: the row
        indices in the merged table of the Cells fn returned, or None where
        it returned something else. `stats`, where given, receives:
        `workers`, the number of distinct processes that synthesized
        instances (1 when synthesis ran serially); `pool_error`, the repr of
        what stopped the pool (None if nothing did); `instances`; `rows`,
        the merged table's; and host seconds: `spawn_s` starting workers (0
        with a kept pool), `pool_s` from handing the work out until every
        instance's table is back in the parent (the serial synthesis where
        it ran serially), `merge_s` the merge and the rebasing of the
        outputs."""
        import os
        import time

        if pool is not None:
            n_workers = pool.n_workers
        elif n_workers is None:
            n_workers = min(os.cpu_count() or 1, n_instances)
        if n_workers > 1:
            import pickle

            try:
                pickle.dumps(fn)
            except Exception:
                n_workers = 1  # closure: cannot ship to spawn workers
        results, workers, spawn_s = None, 1, 0.0
        pool_error = None if pool is None else pool.error
        t_pool = time.perf_counter()
        if n_workers > 1 and n_instances > 1 and pool_error is None:
            own = pool is None
            if own:
                pool = SynthPool(n_workers)
                spawn_s = pool.spawn_s
                t_pool = time.perf_counter()
            try:
                res = pool.map([(fn, i) for i in range(n_instances)],
                               timeout=120 + 30 * n_instances)
                pids, *rest = zip(*res)
                results = list(zip(*rest))
                workers = len(set(pids))
            except Exception as e:  # TimeoutError, pickling, worker crash
                pool_error = repr(e)
                pool.fail(pool_error)
            finally:
                if own:
                    pool.close()
        if results is None:
            results = [_synth_instance(fn, i) for i in range(n_instances)]
        t_merge = time.perf_counter()
        tables = [t for t, _ in results]
        table = merge_tables(tables)
        if outputs is not None:
            outputs[:] = [None if idx is None else idx + off
                          for (_, idx), off in zip(results, row_offsets(tables))]
        t_end = time.perf_counter()
        if stats is not None:
            stats.update(workers=workers, pool_error=pool_error, instances=n_instances,
                         rows=table.n_rows, spawn_s=spawn_s, pool_s=t_merge - t_pool,
                         merge_s=t_end - t_merge)
        return table
