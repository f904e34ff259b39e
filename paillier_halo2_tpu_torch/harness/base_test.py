"""Test/bench harness — re-design of halo2-base's `base_test()` builder.

Counterpart of `paillier_halo2_tpu/harness/base_test.py:1`. Usage:

    base_test().k(16).lookup_bits(15).expect_satisfied(True).run(closure)
    base_test().k(14).lookup_bits(13).device("cuda").bench_builder(init, inp, fn)

`run`'s closure receives (ctx, range_chip) like the reference's (ctx,
range); `run` finalizes the virtual table, sizes the column config (the
config_params dry-run analog) and checks every constraint with the
MockProver. Both run on the card unless the caller asks for
`.device("cpu")`.
"""
from __future__ import annotations

import dataclasses
import time

from ..gadgets.context import Context, VirtualTable
from ..gadgets.range import RangeChip
from ..mock.prover import MockResult, mock_prove_host, mock_prove_torch, require_device
from ..plonk.params import BLINDING_ROWS, ConfigParams

__all__ = ["BLINDING_ROWS", "BaseTester", "ConfigParams", "RunResult", "base_test"]


@dataclasses.dataclass
class RunResult:
    table: VirtualTable
    config: ConfigParams
    mock: MockResult
    synth_time_s: float
    mock_time_s: float


class BaseTester:
    def __init__(self) -> None:
        self._k = 16
        self._lookup_bits = 15
        self._expect_satisfied = True
        self._backend = "torch"
        self._device = "cuda"  # CPU callers ask with .device("cpu")
        self._params_dir: str | None = None

    def k(self, k: int) -> "BaseTester":
        self._k = k
        return self

    def lookup_bits(self, bits: int) -> "BaseTester":
        self._lookup_bits = bits
        return self

    def expect_satisfied(self, flag: bool) -> "BaseTester":
        self._expect_satisfied = flag
        return self

    def backend(self, name: str) -> "BaseTester":
        """"torch" (the counterpart of the JAX package's "jax") or "host"."""
        assert name in ("torch", "host")
        self._backend = name
        return self

    def device(self, device) -> "BaseTester":
        self._device = device
        return self

    def params_dir(self, path: str | None) -> "BaseTester":
        self._params_dir = path
        return self

    def run(self, closure, stats: dict | None = None) -> RunResult:
        """Synthesize, size and mock-prove the closure's circuit; raises if
        the verdict is not the expected one. `stats` as `mock_prove_torch`'s."""
        if self._backend == "torch":
            require_device(self._device, "base_test().run")
        ctx = Context()
        range_chip = RangeChip(ctx, self._lookup_bits)
        t0 = time.monotonic()
        closure(ctx, range_chip)
        table = ctx.finalize()
        t1 = time.monotonic()
        config = ConfigParams.size_for(table, self._k, self._lookup_bits)
        if self._backend == "torch":
            mock = mock_prove_torch(table, self._lookup_bits, self._device, stats)
        else:
            mock = mock_prove_host(table, self._lookup_bits)
        t2 = time.monotonic()
        if self._expect_satisfied:
            mock.assert_satisfied()
        else:
            assert not mock.satisfied, "expected an unsatisfied constraint system"
        return RunResult(table, config, mock, t1 - t0, t2 - t1)

    def bench_builder(self, init_input, logic_input, circuit_fn):
        """Full prove/verify pipeline — the reference's
        `.bench_builder(init_input, input, f)` (upstream src/bench.rs:161-171):
        shape discovery with `init_input`, keygen, witness synthesis with
        `logic_input`, KZG proof, verification. Returns BenchStats; with
        expect_satisfied(True) an unverified proof raises."""
        from .bench import bench_builder as _bench

        stats = _bench(self._k, self._lookup_bits, init_input, logic_input, circuit_fn,
                       self._device, self._params_dir)
        if self._expect_satisfied and not stats.verified:
            raise AssertionError("proof did not verify")
        return stats


def base_test() -> BaseTester:
    return BaseTester()
