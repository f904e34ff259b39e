"""The distributed prover: keygen and proof with their NTTs and
commitments sharded over a mesh.

Counterpart of `paillier_halo2_tpu/plonk/distributed.py:1`. Under
`poly.ops.proving_mesh` the ordinary `keygen` and `create_proof` run every
coefficient/evaluation transform of size n with d^2 | n as the four-step
NTT (`mesh/ntt.py`) and every commitment whose width d divides as the
sharded MSM (`mesh/msm.py`); the rest of the field work stays on
`mesh.devices[0]`. Distribution changes the schedule, not the arithmetic:
the verifying key and the proof bytes equal the single-device ones.
"""
from __future__ import annotations

from ..gadgets.context import VirtualTable
from ..poly import ops
from .keygen import ProvingKey, keygen
from .prover import create_proof
from .srs import SRS


def keygen_sharded(mesh, table: VirtualTable, k: int, lookup_bits: int, srs: SRS,
                   multiopen: str = "shplonk") -> ProvingKey:
    with ops.proving_mesh(mesh):
        return keygen(table, k, lookup_bits, srs, multiopen=multiopen)


def create_proof_sharded(mesh, pk: ProvingKey, table: VirtualTable,
                         blinding_seed: bytes | None = None, checks: str = "closing") -> bytes:
    with ops.proving_mesh(mesh):
        return create_proof(pk, table, blinding_seed, checks=checks)
