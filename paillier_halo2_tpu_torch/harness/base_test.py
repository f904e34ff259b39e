"""Test/bench harness — re-design of halo2-base's `base_test()` builder.

Counterpart of `paillier_halo2_tpu/harness/base_test.py:1`, proving path
only (the MockProver `run` is not ported yet). Builder API:

    base_test().k(14).lookup_bits(13).device("cuda").bench_builder(init, inp, fn)
"""
from __future__ import annotations

from ..plonk.params import BLINDING_ROWS, ConfigParams

__all__ = ["BLINDING_ROWS", "BaseTester", "ConfigParams", "base_test"]


class BaseTester:
    def __init__(self) -> None:
        self._k = 16
        self._lookup_bits = 15
        self._expect_satisfied = True
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

    def device(self, device) -> "BaseTester":
        self._device = device
        return self

    def params_dir(self, path: str | None) -> "BaseTester":
        self._params_dir = path
        return self

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
