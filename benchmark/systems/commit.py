"""The commitment cells: one step is one KZG commitment,
`plonk.kzg.commit(srs, coeffs)`, from the coefficients on the device to the
point on the host.

Set-up makes the SRS of 2^log2_points G1 powers on the device from the
seed and commits `WARM_STEPS` vectors, untimed. Step i draws its own
vector on the device (`draw`: `generate.uniform_fr_limbs`, seeded by the
run's seed and i), so no two steps commit the same coefficients, and
commits it (`run`).

After the window the reference draws again the vectors of a sample of the
window's steps (`reference_sample` of them, chosen from the seed),
evaluates each at the SRS's tau and checks the step's commitment against
[c(tau)]G1.
"""
from __future__ import annotations

import random

from .. import generate
from ..reference import bn254
from ..reference import kzg as ref_kzg

WARM_STEPS = 4


class System:
    def __init__(self, config: dict, traffic: dict, seed: int, device, phases):
        import torch

        from paillier_halo2_tpu_torch.plonk.srs import generate_srs

        self.device = torch.device(device)
        self.log2, self.seed = config["log2_points"], seed
        self.sample = traffic["reference_sample"]
        self.srs_seed = generate.derive(seed, "srs")
        self.srs = generate_srs(self.log2, self.srs_seed, self.device)
        self.spans: dict[str, list[float]] = {}
        for i in range(WARM_STEPS):  # warm-up, untimed
            self.run(-1 - i, self.draw(-1 - i), phases)
        self.work_per_step = 1 << self.log2
        self.inputs = {"points": 1 << self.log2, "scalar_bits": bn254.R.bit_length()}

    def draw(self, i: int):
        return generate.uniform_fr_limbs(self.log2, self.seed, i, self.device)

    def run(self, i: int, coeffs, phases):
        from paillier_halo2_tpu_torch.plonk import kzg

        with phases.span("commit"):
            return i, kzg.commit(self.srs, coeffs)

    def release(self) -> None:
        self.srs = None

    def checked(self, records: list) -> list:
        """The completed steps the reference checks: a sample drawn from the
        seed, in window order."""
        done = [r for r in records if r is not None]
        prng = random.Random(generate.derive(self.seed, "reference_sample"))
        return sorted(prng.sample(done, min(self.sample, len(done))))

    def reference_point(self, i: int, truncate_bits: int | None = None):
        """[c(tau)]G1 of step i's vector, drawn again."""
        coeffs = ref_kzg.limbs_to_ints(self.draw(i).cpu().numpy())
        return ref_kzg.commit_monomial_mont(coeffs, ref_kzg.dev_tau(self.srs_seed), truncate_bits)

    def control(self, records: list) -> dict:
        """The control's points, by step: the reference put in the program's
        place with every coefficient cut to its low 253 bits, one bit below
        Fr's."""
        return {i: self.reference_point(i, bn254.R.bit_length() - 1) for i, _ in self.checked(records)}

    def check(self, records: list, want: dict | None = None) -> dict:
        """Counts of what the reference finds wrong, by name; `want` (points
        by step) stands in for the reference's points (the control)."""
        sample = self.checked(records)
        if want is None:
            want = {i: self.reference_point(i) for i, _ in sample}
        return {"steps_failed": sum(r is None for r in records),
                "commitments_wrong": sum(pt != want[i] for i, pt in sample)}
