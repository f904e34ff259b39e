"""BN254 field layer of the PyTorch port (counterpart of
`paillier_halo2_tpu/ff/__init__.py:1`)."""
from . import host
from .field import FQ, FR, FieldSpec, from_ref_digits, to_ref_digits

__all__ = ["host", "FieldSpec", "FR", "FQ", "from_ref_digits", "to_ref_digits"]
