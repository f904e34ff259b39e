"""Harness of the PyTorch port (counterpart of
`paillier_halo2_tpu/harness/__init__.py:1`)."""
from .base_test import BLINDING_ROWS, BaseTester, ConfigParams, RunResult, base_test
from .bench import BenchStats, bench_builder
from .circuits import (
    PaillierAddCipherInput,
    PaillierEncryptionInput,
    paillier_enc_add_test,
    paillier_enc_batch,
    paillier_enc_test,
)

__all__ = [
    "BLINDING_ROWS",
    "BaseTester",
    "BenchStats",
    "ConfigParams",
    "PaillierAddCipherInput",
    "PaillierEncryptionInput",
    "RunResult",
    "base_test",
    "bench_builder",
    "paillier_enc_add_test",
    "paillier_enc_batch",
    "paillier_enc_test",
]
