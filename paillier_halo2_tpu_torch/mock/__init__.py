"""MockProver of the PyTorch port (counterpart of
`paillier_halo2_tpu/mock/__init__.py:1`)."""
from .prover import (
    MockResult,
    check_constraints,
    mock_prove_chunked,
    mock_prove_host,
    mock_prove_torch,
)

__all__ = ["MockResult", "check_constraints", "mock_prove_chunked", "mock_prove_host",
           "mock_prove_torch"]
