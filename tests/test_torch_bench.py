"""The PyTorch port's main-path entry, `base_test().bench_builder`
(`harness/base_test.py`, `harness/bench.py`), end to end at k=10 on the CPU:
SRS created into an empty cache directory, keygen, witness synthesis, a
random-blinded proof, verification and the `BenchStats` it reports. On the
CPU the commitments run the native engine.
(The K=10 proof held byte for byte against the JAX package is in
`test_torch_slice.py`.)
"""
import os
import random

import torch

from paillier_halo2_tpu_torch.bignum.host import paillier_add_native
from paillier_halo2_tpu_torch.harness.base_test import base_test
from paillier_halo2_tpu_torch.harness.circuits import PaillierAddCipherInput, paillier_enc_add_test

# pytest-xdist workers share the machine's cores: each worker's torch takes
# its share instead of all of them, so workers do not oversubscribe the CPU.
torch.set_num_threads(
    max(1, len(os.sched_getaffinity(0)) // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))
)


def test_bench_builder_k10_verifies(tmp_path):
    """The harness's main-path entry at k=10, on the add circuit: SRS created
    into an empty cache directory, keygen, witness, random-blinded proof,
    verify."""
    prng = random.Random(7)
    enc, limb = 16, 8
    n = prng.getrandbits(enc) | (1 << (enc - 1)) | 1
    g, c1, c2 = (prng.getrandbits(enc) for _ in range(3))
    inp = PaillierAddCipherInput(limb, enc, n, g, c1, c2, paillier_add_native(n, c1, c2))
    stats = (
        base_test().k(10).lookup_bits(9).expect_satisfied(True).device("cpu")
        .params_dir(str(tmp_path))
        .bench_builder(inp, inp, paillier_enc_add_test)
    )
    assert stats.verified
    assert (tmp_path / "kzg_bn254_dev_10.npz").exists()
    assert stats.proof_size > 0 and stats.proof_size % 32 == 0
    assert min(stats.srs_time, stats.keygen_vk_time, stats.proof_time) > 0
    assert "verified=True" in stats.pretty()
