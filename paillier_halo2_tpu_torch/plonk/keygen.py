"""Key generation — replacement for halo2-axiom's keygen_vk/keygen_pk.

Counterpart of `paillier_halo2_tpu/plonk/keygen.py:1`. The proving key
precomputes, once per circuit shape: the column layout, every fixed
polynomial (selectors, constant column, range table, permutation sigmas,
active-row indicator, boundary Lagrange polys) in Montgomery coefficient form
on the SRS's device, and their commitments (the verifying key).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..ec import host as ech
from ..ff import host
from ..gadgets.context import VirtualTable
from ..poly import ops
from ..utils.trace import PhaseTimer
from .kzg import commit_many
from .layout import CircuitLayout, assign_layout
from .params import BLINDING_ROWS
from .srs import SRS

P = host.FR_MOD

# delta: generator of the 2^28-torsion-free part of Fr* — coset representatives
# delta^j H are pairwise disjoint for the permutation identity columns.
DELTA = pow(host.FR_GENERATOR, 1 << host.FR_TWO_ADICITY, P)

EXTENDED_RATE_BITS = 2  # max constraint degree 4 -> extended domain 4n
PERM_CHUNK = 2  # permutation columns per grand-product (degree 2+PERM_CHUNK)
# Multi-open schemes: "shplonk" (BDFG20, two W points, the halo2-axiom
# harness default) and "gwc" (GWC19, one W point per opening point).
MULTIOPEN_SCHEMES = ("shplonk", "gwc")


@dataclasses.dataclass
class VerifyingKey:
    k: int
    lookup_bits: int
    num_advice: int
    num_lookup_advice: int
    n_perm_cols: int
    perm_chunks: list[list[int]]
    usable: int
    multiopen: str = "shplonk"  # one of MULTIOPEN_SCHEMES; prover and verifier follow it
    num_instance: int = 0
    q_commits: list[ech.Point] = dataclasses.field(default_factory=list)
    fixed_const_commit: ech.Point = None
    table_commit: ech.Point = None
    sigma_commits: list[ech.Point] = dataclasses.field(default_factory=list)

    @property
    def n(self) -> int:
        return 1 << self.k

    def fixed_commitments(self) -> list[ech.Point]:
        return [*self.q_commits, self.fixed_const_commit, self.table_commit, *self.sigma_commits]


@dataclasses.dataclass
class ProvingKey:
    vk: VerifyingKey
    layout: CircuitLayout
    srs: SRS
    # device Montgomery coefficient forms, (8, n) each
    q_coeffs: list[torch.Tensor]
    fixed_const_coeffs: torch.Tensor
    table_coeffs: torch.Tensor
    sigma_coeffs: list[torch.Tensor]
    active_coeffs: torch.Tensor
    l0_coeffs: torch.Tensor
    lu_coeffs: torch.Tensor
    table_values: np.ndarray  # (n,) object ints
    fixed_const_values: np.ndarray
    # seconds of the last keygen per phase; "commit" is the verifying-key share
    phase_times: dict = dataclasses.field(default_factory=dict)

    @property
    def k(self) -> int:
        return self.vk.k


def check_multiopen(multiopen: str) -> None:
    if multiopen not in MULTIOPEN_SCHEMES:
        raise ValueError(f"multi-open scheme {multiopen!r} is not one of {MULTIOPEN_SCHEMES}")


def permutation_powers(k: int, n_perm_cols: int) -> tuple[np.ndarray, np.ndarray]:
    """(delta^j for j < n_perm_cols, omega^r for r < 2^k) as object ints:
    cell (j, r) of the permutation's identity is delta^j * omega^r."""
    n = 1 << k
    omega_pows = [1] * n
    w = host.root_of_unity(k)
    for i in range(1, n):
        omega_pows[i] = omega_pows[i - 1] * w % P
    delta_pows = [1] * n_perm_cols
    for j in range(1, n_perm_cols):
        delta_pows[j] = delta_pows[j - 1] * DELTA % P
    return np.array(delta_pows, dtype=object), np.array(omega_pows, dtype=object)


def keygen(table: VirtualTable, k: int, lookup_bits: int, srs: SRS,
           multiopen: str = "shplonk") -> ProvingKey:
    """`multiopen` picks the scheme the key's proofs open with (the JAX
    package reads PAILLIER_TPU_MULTIOPEN instead); the key lives on the
    SRS's device."""
    from .prover import column_slab

    check_multiopen(multiopen)
    timer = PhaseTimer("keygen")
    device = srs.device
    assert srs.k >= k
    layout = assign_layout(table, k, lookup_bits)
    timer.mark("layout assigned")
    n = 1 << k
    usable = n - BLINDING_ROWS
    na = layout.num_advice
    nl = layout.num_lookup_advice
    n_perm_cols = layout.n_perm_cols

    # -- fixed value columns ---------------------------------------------------
    q_vals = [layout.q[c].astype(object) for c in range(na)]
    fixed_const_vals = layout.fixed_const
    assert (1 << lookup_bits) <= usable, "range table does not fit active region"
    table_vals = np.zeros(n, dtype=object)
    table_vals[: 1 << lookup_bits] = np.arange(1 << lookup_bits).astype(object)

    delta_arr, omega_arr = permutation_powers(k, n_perm_cols)
    sigma_values = delta_arr[layout.sigma_col] * omega_arr[layout.sigma_row] % P

    active_vals = np.zeros(n, dtype=object)
    active_vals[:usable] = 1
    l0_vals = np.zeros(n, dtype=object)
    l0_vals[0] = 1
    lu_vals = np.zeros(n, dtype=object)
    lu_vals[usable] = 1

    # -- coefficient forms (one batched iNTT per slab) + commitments -----------
    timer.mark("fixed values built")
    fixed_stack = np.stack(
        q_vals
        + [fixed_const_vals, table_vals]
        + [sigma_values[j] for j in range(n_perm_cols)]
        + [active_vals, l0_vals, lu_vals]
    )
    stack_dev = ops.to_device_mont(fixed_stack, device)  # (8, m, n)
    ch = column_slab(device, n)
    all_coeffs = torch.cat(
        [ops.coeffs_of(stack_dev[:, c0 : c0 + ch], k) for c0 in range(0, stack_dev.shape[1], ch)],
        dim=1,
    )
    del stack_dev
    timer.mark("fixed coeffs (batched iNTT)")
    cols = [all_coeffs[:, i].contiguous() for i in range(all_coeffs.shape[1])]
    q_coeffs = cols[:na]
    fixed_const_coeffs = cols[na]
    table_coeffs = cols[na + 1]
    sigma_coeffs = cols[na + 2 : na + 2 + n_perm_cols]
    active_coeffs, l0_coeffs, lu_coeffs = cols[na + 2 + n_perm_cols :]

    perm_chunks = [
        list(range(s, min(s + PERM_CHUNK, n_perm_cols)))
        for s in range(0, n_perm_cols, PERM_CHUNK)
    ]

    t_commit = time.monotonic()
    all_commits = commit_many(srs, q_coeffs + [fixed_const_coeffs, table_coeffs] + sigma_coeffs)
    phase_times = {"commit": time.monotonic() - t_commit}
    timer.mark("fixed commitments (batched MSM)")

    vk = VerifyingKey(
        k=k,
        lookup_bits=lookup_bits,
        num_advice=na,
        num_lookup_advice=nl,
        n_perm_cols=n_perm_cols,
        perm_chunks=perm_chunks,
        usable=usable,
        multiopen=multiopen,
        num_instance=layout.num_instance,
        q_commits=all_commits[:na],
        fixed_const_commit=all_commits[na],
        table_commit=all_commits[na + 1],
        sigma_commits=all_commits[na + 2 :],
    )
    return ProvingKey(
        vk=vk,
        layout=layout,
        srs=srs,
        q_coeffs=q_coeffs,
        fixed_const_coeffs=fixed_const_coeffs,
        table_coeffs=table_coeffs,
        sigma_coeffs=sigma_coeffs,
        active_coeffs=active_coeffs,
        l0_coeffs=l0_coeffs,
        lu_coeffs=lu_coeffs,
        table_values=table_vals,
        fixed_const_values=fixed_const_vals,
        phase_times=phase_times,
    )
