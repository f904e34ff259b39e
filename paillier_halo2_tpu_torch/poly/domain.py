"""Evaluation domains over Fr — replacement for halo2-axiom's EvaluationDomain
(SURVEY.md section 2.2, "NTT/iNTT"). Host-side constants only.

Counterpart of `paillier_halo2_tpu/poly/domain.py:1` (same class, no device
state; the NTT tables live in `poly/ntt.py`).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np

from ..ff import host


@dataclasses.dataclass(frozen=True)
class Domain:
    """Radix-2 multiplicative subgroup H of size n = 2^k, plus the extended
    coset domain used for quotient construction (size n * rate, coset gH')."""

    k: int
    extended_rate_bits: int = 2  # extended domain = 2^(k + rate_bits)

    @property
    def n(self) -> int:
        return 1 << self.k

    @property
    def k_ext(self) -> int:
        return self.k + self.extended_rate_bits

    @property
    def n_ext(self) -> int:
        return 1 << self.k_ext

    @functools.cached_property
    def omega(self) -> int:
        return host.root_of_unity(self.k)

    @functools.cached_property
    def omega_inv(self) -> int:
        return pow(self.omega, host.FR_MOD - 2, host.FR_MOD)

    @functools.cached_property
    def omega_ext(self) -> int:
        return host.root_of_unity(self.k_ext)

    @functools.cached_property
    def coset_gen(self) -> int:
        """Generator of the extended coset (halo2 uses the field generator)."""
        return host.FR_GENERATOR

    def powers(self, base: int, count: int) -> list[int]:
        out, acc = [], 1
        for _ in range(count):
            out.append(acc)
            acc = acc * base % host.FR_MOD
        return out
