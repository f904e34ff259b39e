"""Constraint-synthesis gadgets of the PyTorch port (host-only copies of
`paillier_halo2_tpu/gadgets/`, counterpart `paillier_halo2_tpu/gadgets/__init__.py:1`)."""
from .biguint import AssignedBigUint, BigUintChip, RefreshAux
from .context import Cells, Context, SinglePhaseCoreManager, VirtualTable
from .gate import GateChip
from .paillier import EncryptionPublicKeyAssigned, PaillierChip
from .range import RangeChip

__all__ = [
    "Context",
    "Cells",
    "SinglePhaseCoreManager",
    "VirtualTable",
    "GateChip",
    "RangeChip",
    "BigUintChip",
    "AssignedBigUint",
    "RefreshAux",
    "PaillierChip",
    "EncryptionPublicKeyAssigned",
]
