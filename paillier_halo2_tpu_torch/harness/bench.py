"""Bench harness — the `bench_builder` path of base_test.

Counterpart of `paillier_halo2_tpu/harness/bench.py:1` (upstream use-site
src/bench.rs:161-178; halo2-base BenchStats). Runs the full pipeline: shape
discovery, SRS load or creation, keygen, witness synthesis, proof creation
and verification, reporting the same stat fields: keygen splits into
`keygen_vk_time` (fixed-poly commitments, the verifying-key half) and
`keygen_pk_time` (layout + coefficient forms), and witness synthesis has its
own `witness_time`. Every device tensor lives on `device`, the card unless
the caller passes "cpu".
"""
from __future__ import annotations

import dataclasses
import time

import torch

from ..gadgets.context import Context
from ..gadgets.range import RangeChip
from ..plonk.keygen import keygen
from ..plonk.params import ConfigParams
from ..plonk.prover import create_proof
from ..plonk.srs import read_or_create_srs
from ..plonk.verifier import verify_proof


@dataclasses.dataclass
class BenchStats:
    config_params: ConfigParams
    srs_time: float
    keygen_vk_time: float  # fixed-commitment (verifying-key) share of keygen
    keygen_pk_time: float  # layout + coefficient-form (proving-key) share
    witness_time: float  # phase-B circuit synthesis (witness generation)
    proof_time: float
    proof_size: int
    verify_time: float
    verified: bool

    @property
    def vk_time(self) -> float:
        return self.keygen_vk_time

    @property
    def pk_time(self) -> float:
        return self.keygen_pk_time

    @property
    def keygen_time(self) -> float:
        return self.keygen_vk_time + self.keygen_pk_time

    def pretty(self) -> str:
        return (
            f"config params = {self.config_params}\n"
            f"srs time = {self.srs_time:.3f}s\n"
            f"vk (fixed commitments) time = {self.keygen_vk_time:.3f}s\n"
            f"pk (layout+coeffs) time = {self.keygen_pk_time:.3f}s\n"
            f"witness synthesis time = {self.witness_time:.3f}s\n"
            f"proof time = {self.proof_time:.3f}s\n"
            f"proof size = {self.proof_size}\n"
            f"verify time = {self.verify_time:.3f}s (verified={self.verified})"
        )


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def bench_builder(k: int, lookup_bits: int, init_input, logic_input, circuit_fn, device="cuda",
                  params_dir: str | None = None) -> BenchStats:
    """circuit_fn(ctx, range_chip, input) builds the circuit, as the closure
    at upstream src/bench.rs:165-171. `params_dir` holds the SRS cache."""
    # Phase A: shape discovery with the init input.
    ctx = Context()
    circuit_fn(ctx, RangeChip(ctx, lookup_bits), init_input)
    shape_table = ctx.finalize()

    t0 = time.monotonic()
    srs = read_or_create_srs(k, device=device, params_dir=params_dir)
    _sync(device)
    t1 = time.monotonic()
    pk = keygen(shape_table, k, lookup_bits, srs)
    _sync(device)
    t2 = time.monotonic()
    vk_share = pk.phase_times["commit"]

    # Phase B: witness generation with the logic input (fresh synthesis).
    ctx2 = Context()
    circuit_fn(ctx2, RangeChip(ctx2, lookup_bits), logic_input)
    table = ctx2.finalize()
    if table.n_rows != shape_table.n_rows:
        raise ValueError("circuit shape depends on the witness")
    t3 = time.monotonic()
    proof = create_proof(pk, table)
    _sync(device)
    t4 = time.monotonic()
    ok = verify_proof(pk.vk, srs, proof)
    t5 = time.monotonic()

    return BenchStats(
        config_params=pk.layout.config,
        srs_time=t1 - t0,
        keygen_vk_time=vk_share,
        keygen_pk_time=(t2 - t1) - vk_share,
        witness_time=t3 - t2,
        proof_time=t4 - t3,
        proof_size=len(proof),
        verify_time=t5 - t4,
        verified=ok,
    )
