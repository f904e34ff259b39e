"""The reference agrees with the port on small configurations on the CPU,
and tells a tampered proof or point apart."""
from __future__ import annotations

import random

import pytest

from benchmark import generate
from benchmark.reference import bn254, kzg
from benchmark.reference.circuit import paillier_encrypt


@pytest.mark.parametrize("cell", ["k14_enc", "k14_add", "msm_2e20_uniform"])
def test_window_judged_correct(run_cpu, cell):
    rc, res = run_cpu(cell)
    assert rc == 0 and res["correct"] is True
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert all(c["value"] == 0 and c["limit"] == 0 for c in res["checks"].values())


def test_commitment_at_tau_matches_the_port():
    import torch

    from paillier_halo2_tpu_torch.plonk import kzg as port_kzg
    from paillier_halo2_tpu_torch.plonk.srs import generate_srs

    seed = generate.derive(7, "srs")
    srs = generate_srs(6, seed, "cpu")
    coeffs = generate.uniform_fr_limbs(6, 7, 3, "cpu")
    assert torch.equal(coeffs, generate.uniform_fr_limbs(6, 7, 3, "cpu"))
    assert not torch.equal(coeffs, generate.uniform_fr_limbs(6, 7, 4, "cpu"))
    want = kzg.commit_monomial_mont(kzg.limbs_to_ints(coeffs.numpy()), kzg.dev_tau(seed))
    assert port_kzg.commit(srs, coeffs) == want
    assert torch.all(coeffs[7].to(torch.int64) & 0xFFFFFFFF < bn254.R >> 224)


def test_lagrange_commitment_is_the_monomial_one():
    tau, k = kzg.dev_tau(b"x"), 4
    vals = [random.Random(1).randrange(bn254.R) for _ in range(16)]
    basis = kzg.lagrange_at(tau, k)
    w = bn254.root_of_unity(k)
    # p(w^i) = vals[i]; evaluate the interpolant at tau directly
    pts = [pow(w, i, bn254.R) for i in range(16)]
    direct = 0
    for i, xi in enumerate(pts):
        term = vals[i]
        for j, xj in enumerate(pts):
            if j != i:
                term = term * (tau - xj) % bn254.R * pow(xi - xj, -1, bn254.R) % bn254.R
        direct = (direct + term) % bn254.R
    assert kzg.eval_lagrange(vals, basis) == direct


def test_statements_follow_the_traffic_spec():
    spec = {"statement": "paillier_encrypt", "per_run": {"n": {"top": True, "odd": True, "ones_share": 0.5},
                                                          "g": {}},
            "per_step": {"m": {"top": True, "ones_share": 0.5}, "r": {}}}
    s = generate.statements(spec, 128, 2 ** 31 + 5)
    a, b = next(s), next(s)
    assert a["n"] == b["n"] and a["g"] == b["g"] and (a["m"], a["r"]) != (b["m"], b["r"])
    assert bin(b["m"]).count("1") == 64 and b["m"].bit_length() == 128
    assert bin(a["n"]).count("1") == 64 and a["n"] & 1 and a["n"] >> 127 == 1
    assert bin(a["m"]).count("1") == 64 and a["m"].bit_length() == 128
    assert a["res"] == paillier_encrypt(a["n"], a["g"], a["m"], a["r"])
    again = generate.statements(spec, 128, 2 ** 31 + 5)
    assert next(again) == a
