"""The prover's cells: one step is one proof of a fresh Paillier statement,
from the statement handed to the port to the proof's bytes on the host.

Set-up makes the SRS on the device from the seed and, where the traffic
makes the key once a run (`"keygen": "per_run"`), synthesizes one
statement and runs keygen (no key file is written or read); then one
untimed step. A step (`run`) synthesizes its statement (`draw`) in a fresh
`Context` (`harness.circuits`) and finalizes it; where the traffic makes a
key for every statement (`"per_step"`: the statement's own bits shape the
circuit), it runs keygen on that table; then it calls
`plonk.prover.create_proof` with a blinding seed drawn from the run's seed.

After the window the reference checks every proof of the window: the
ciphertext in the cells the circuit returned, the table's gates, copies,
constants and lookups, the advice and lookup commitments against the
witness with the proof's blinding, and the proof against a verifying key
that the reference works out again from the proof's own table
(`reference/`).
"""
from __future__ import annotations

import time

from .. import generate
from ..reference import circuit as ref_circuit
from ..reference import kzg as ref_kzg
from ..reference import layout as ref_layout
from ..reference import verifier as ref_verifier

CHECKS = ("steps_failed", "ciphertexts_wrong", "table_violations", "commitments_wrong",
          "proofs_rejected")


def _circuit(kind: str, cfg: dict, st: dict):
    from paillier_halo2_tpu_torch.harness import circuits

    if kind == "paillier_encrypt":
        return circuits.paillier_enc_test, circuits.PaillierEncryptionInput(
            enc_bits=cfg["enc_bits"], limb_bits=cfg["limb_bits"], **st)
    return circuits.paillier_enc_add_test, circuits.PaillierAddCipherInput(
        enc_bits=cfg["enc_bits"], limb_bits=cfg["limb_bits"], **st)


KEYGEN = ("per_run", "per_step")


class System:
    """`run(i, draw(i), phases)` proves the i-th statement of the window."""

    def __init__(self, config: dict, traffic: dict, seed: int, device, phases):
        import torch

        from paillier_halo2_tpu_torch.plonk.srs import generate_srs

        if traffic["keygen"] not in KEYGEN:
            raise ValueError(f"keygen {traffic['keygen']!r}: one of {KEYGEN}")
        self.cfg, self.seed, self.device = config, seed, torch.device(device)
        self.kind = traffic["statement"]
        self.key_per_step = traffic["keygen"] == "per_step"
        self.stream = generate.statements(traffic, config["enc_bits"], seed)
        self.srs_seed = generate.derive(seed, "srs")
        self.srs = generate_srs(config["k"], self.srs_seed, self.device)
        self.pk = None if self.key_per_step else self._keygen(self._synth(self.draw(-1))[0])
        self.spans: dict[str, list[float]] = {}
        self.run(-1, self.draw(-1), phases)  # warm-up: every shape of a step, untimed
        self.spans = {}
        self.work_per_step = 1
        self.inputs: dict = {}

    def draw(self, i: int) -> dict:
        return next(self.stream)

    def _synth(self, st: dict):
        from paillier_halo2_tpu_torch.gadgets.context import Context
        from paillier_halo2_tpu_torch.gadgets.range import RangeChip

        fn, inp = _circuit(self.kind, self.cfg, st)
        ctx = Context()
        out = fn(ctx, RangeChip(ctx, self.cfg["lookup_bits"]), inp)
        return ctx.finalize(), out.limbs.idx.copy()

    def _keygen(self, table):
        from paillier_halo2_tpu_torch.plonk.keygen import keygen

        return keygen(table, self.cfg["k"], self.cfg["lookup_bits"], self.srs,
                      multiopen=self.cfg["multiopen"])

    def _sync(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _span(self, name: str, t0: float) -> float:
        t1 = time.perf_counter()
        self.spans.setdefault(name, []).append(t1 - t0)
        return t1

    def run(self, i: int, st: dict, phases, tamper: bool = False) -> dict:
        """Prove statement `st`. `tamper` makes the control's proof of a
        false statement: the ciphertext's lowest limb is raised by one in
        the table after synthesis (and after keygen, which reads the
        structure alone) and the table is proved with the prover's
        self-checks off (they would refuse it)."""
        from paillier_halo2_tpu_torch.plonk.prover import create_proof

        t = time.perf_counter()
        with phases.span("synthesis"):
            table, cipher_idx = self._synth(st)
        t = self._span("synth_s", t)
        pk = self.pk
        if self.key_per_step:
            with phases.span("keygen"):
                pk = self._keygen(table)
                self._sync()
            t = self._span("keygen_s", t)
        if tamper:
            table.values[cipher_idx[0]] = (int(table.values[cipher_idx[0]]) + 1) % ref_kzg.R
        blinding = generate.derive(self.seed, f"blinding:{i}")
        with phases.span("create_proof"):
            proof = create_proof(pk, table, blinding_seed=blinding, timer=phases,
                                 checks="none" if tamper else self.cfg["checks"])
            self._sync()
        self._span("create_proof_s", t)
        return {"statement": st, "table": table, "cipher_idx": cipher_idx, "proof": proof,
                "blinding": blinding}

    def release(self) -> None:
        self.pk = self.srs = None

    def check(self, records: list) -> dict:
        """Counts of what the reference finds wrong, by name (`CHECKS`)."""
        cfg = self.cfg
        out = dict.fromkeys(CHECKS, 0)
        out["steps_failed"] = sum(r is None for r in records)
        done = [r for r in records if r is not None]
        if not done:
            return out
        tau = ref_kzg.dev_tau(self.srs_seed)
        basis = ref_kzg.lagrange_at(tau, cfg["k"])
        vk = None
        encrypt = self.kind == "paillier_encrypt"
        for r in done:
            st, table = r["statement"], r["table"]
            want = (ref_circuit.paillier_encrypt(st["n"], st["g"], st["m"], st["r"]) if encrypt
                    else ref_circuit.paillier_add(st["n"], st["c1"], st["c2"]))
            got = ref_circuit.recompose(table.values, r["cipher_idx"], cfg["limb_bits"])
            out["ciphertexts_wrong"] += int(got != want)
            out["table_violations"] += ref_circuit.violations(table, cfg["lookup_bits"])
            if self.key_per_step or vk is None:
                # the key the proof was made under, worked out again from its table
                vk = ref_layout.verifying_key(ref_layout.assign(table, cfg["k"], cfg["lookup_bits"]), basis)
            elif not ref_layout.same_structure(table, done[0]["table"]):
                out["table_violations"] += 1
            adv, lk = ref_layout.witness_columns(table, vk.layout, r["blinding"])
            proof = r["proof"]
            for j, col in enumerate(adv + lk):
                try:
                    pt = ref_verifier.point_from_bytes(proof[32 * j : 32 * j + 32])
                except ValueError:
                    pt = None
                out["commitments_wrong"] += int(pt != ref_kzg.commit_lagrange(col, basis))
            ok, _ = ref_verifier.verify(vk, proof, tau)
            out["proofs_rejected"] += int(not ok)
        return out
