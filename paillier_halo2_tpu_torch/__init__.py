"""paillier_halo2_tpu_torch — the PyTorch/CUDA port of paillier_halo2_tpu.

Counterpart of `paillier_halo2_tpu/__init__.py:1`, with the same layer map:

- ff/       BN254 Fr/Fq limb-tensor arithmetic; K1 (`mulmod`) + host oracles
- bignum/   limb decompose/recompose + witness big-uint math (host)
- gadgets/  constraint synthesis: Context, GateChip, RangeChip, BigUintChip,
            PaillierChip (host)
- poly/     NTT/iNTT, evaluation domains and polynomial ops over Fr
- ec/       BN254 G1 point arithmetic (K2-K4 in `point_kernels`) + host G1/G2
            and pairing
- msm/      Pippenger multi-scalar multiplication
- plonk/    PLONKish proving system: SRS, keygen, prover, verifier, KZG,
            transcript
- harness/  base_test()-style builder, bench_builder and BenchStats
- native/   ctypes bindings of the host C++ engine
- csrc/     the hand-written CUDA kernels for Hopper (sm_90a)

It imports torch and never jax; importing it needs no CUDA and no nvcc.
"""

__version__ = "0.1.0"
