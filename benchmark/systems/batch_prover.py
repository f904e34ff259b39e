"""The batch prover's cells: one step is one proof of a batch of fresh
Paillier encryptions under the run's one public key, from the statements
handed to the port to the proof's bytes on the host.

Set-up makes the SRS on the device from the seed, starts one witness pool
(`gadgets.context.SynthPool`, the configuration's `synth_workers`, no more
than the host's cores) that the run keeps, then makes one untimed step. A
step (`run`) draws the configuration's `batch` statements (`draw`),
synthesizes them into one merged table through
`harness.circuits.paillier_enc_batch` in the pool, runs keygen on that
table (every message's bits shape the circuit) and calls
`plonk.prover.create_proof` with a blinding seed drawn from the run's seed.
Besides the prover cells' spans, a step records the program's own split of
synthesis (`synth_pool_s`, `synth_merge_s`, `synth_workers`).

After the window the reference checks every proof of the window as
`systems/prover.py` does, and the ciphertext of every instance of the
batch against Paillier of its own statement, in the statements' order.
"""
from __future__ import annotations

import os
import sys
import time

from .. import generate
from ..reference import circuit as ref_circuit
from ..reference import kzg as ref_kzg
from . import prover


class System(prover.System):
    """`run(i, draw(i), phases)` proves the i-th batch of the window."""

    def __init__(self, config: dict, traffic: dict, seed: int, device, phases):
        from paillier_halo2_tpu_torch.gadgets.context import SynthPool

        if traffic["statement"] != "paillier_encrypt" or traffic["keygen"] != "per_step":
            raise ValueError("a batch prover proves encryptions, with a key for every step")
        self.batch = config["batch"]
        workers = min(config["synth_workers"], os.cpu_count() or 1, self.batch)
        self.pool = SynthPool(workers) if workers > 1 else None
        self._pool_error = None
        try:
            super().__init__(config, traffic, seed, device, phases)
        except BaseException:
            self.release()
            raise

    def draw(self, i: int) -> list[dict]:
        return [next(self.stream) for _ in range(self.batch)]

    def _synth_batch(self, sts: list[dict]):
        from paillier_halo2_tpu_torch.harness.circuits import paillier_enc_batch

        inputs = [prover._circuit(self.kind, self.cfg, st)[1] for st in sts]
        stats: dict = {}
        table, cipher_idx = paillier_enc_batch(
            inputs, self.cfg["lookup_bits"], pool=self.pool, stats=stats,
            n_workers=1 if self.pool is None else None)
        for name, key in (("synth_pool_s", "pool_s"), ("synth_merge_s", "merge_s"),
                          ("synth_workers", "workers")):
            self.spans.setdefault(name, []).append(stats[key])
        if stats["pool_error"] != self._pool_error:
            self._pool_error = stats["pool_error"]
            print(f"the witness pool failed, synthesis runs serially: {self._pool_error}",
                  file=sys.stderr, flush=True)
        return table, cipher_idx

    def run(self, i: int, sts: list[dict], phases, tamper: bool = False) -> dict:
        """Prove the batch `sts`. `tamper` makes the control's proof of a
        false batch: the lowest ciphertext limb of the first instance is
        raised by one in the table after keygen, and the table is proved
        with the prover's self-checks off (they would refuse it)."""
        from paillier_halo2_tpu_torch.plonk.prover import create_proof

        t = time.perf_counter()
        with phases.span("synthesis"):
            table, cipher_idx = self._synth_batch(sts)
        t = self._span("synth_s", t)
        with phases.span("keygen"):
            pk = self._keygen(table)
            self._sync()
        t = self._span("keygen_s", t)
        if tamper:
            low = cipher_idx[0][0]
            table.values[low] = (int(table.values[low]) + 1) % ref_kzg.R
        blinding = generate.derive(self.seed, f"blinding:{i}")
        with phases.span("create_proof"):
            proof = create_proof(pk, table, blinding_seed=blinding, timer=phases,
                                 checks="none" if tamper else self.cfg["checks"])
            self._sync()
        self._span("create_proof_s", t)
        return {"statements": sts, "table": table, "cipher_idx": cipher_idx, "proof": proof,
                "blinding": blinding}

    def release(self) -> None:
        if self.pool is not None:
            self.pool.close()
        super().release()

    def check(self, records: list) -> dict:
        """Counts of what the reference finds wrong, by name (`prover.CHECKS`):
        `prover.System.check` of every proof (the table, the commitments,
        the verifier, and the first instance's ciphertext), then the
        ciphertext of every further instance, and one for every statement
        without a ciphertext or ciphertext without a statement."""
        firsts = [None if r is None else {**r, "statement": r["statements"][0],
                                          "cipher_idx": r["cipher_idx"][0]}
                  for r in records]
        out = super().check(firsts)
        for r in filter(None, records):
            sts, idx = r["statements"], r["cipher_idx"]
            out["ciphertexts_wrong"] += abs(len(sts) - len(idx)) + sum(
                int(ref_circuit.recompose(r["table"].values, ix, self.cfg["limb_bits"])
                    != ref_circuit.paillier_encrypt(st["n"], st["g"], st["m"], st["r"]))
                for st, ix in zip(sts[1:], idx[1:]))
        return out
