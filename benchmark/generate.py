"""The one generator of the benchmark's traffic: every input of a run is
drawn here from `--seed`, by the parameters of the cell's traffic file.

- Paillier statements (`"statement"` in the traffic file): each field
  `enc_bits` bits wide, drawn once per run (`"per_run"`) or for every step
  (`"per_step"`), as the traffic file says. A field's spec may set its top
  bit (`"top"`), make it odd (`"odd"`), or fix its number of one bits
  (`"ones_share"` of its width). The expected ciphertext is worked out by
  the reference's own Paillier.
- Paillier statements may also say when the key is made (`"keygen"`):
  once a run (`"per_run"`), where no field of `per_step` shapes the
  circuit, or for every statement (`"per_step"`), where one does.
- KZG coefficients (`"coefficients": "uniform_fr"`): for every step a fresh
  vector of 2^log2_points scalars, drawn on the device by a
  `torch.Generator` seeded from the run's seed and the step's index, so
  that any step's vector can be drawn again after the window; 32-bit
  little-endian limbs in Montgomery form, the top limb below r's so that
  every value lies in [0, r).
"""
from __future__ import annotations

import hashlib
import random

from .reference.bn254 import R
from .reference.circuit import paillier_add, paillier_encrypt


def derive(seed: int, label: str) -> bytes:
    """32 bytes for one purpose of one run, from its seed."""
    return hashlib.blake2b(f"{label}:{seed}".encode(), digest_size=32).digest()


def draw(prng: random.Random, bits: int, spec: dict) -> int:
    """One field of a statement by its spec."""
    forced = {bits - 1} if spec.get("top") else set()
    if spec.get("odd"):
        forced.add(0)
    if "ones_share" in spec:
        ones = round(bits * spec["ones_share"])
        rest = prng.sample(sorted(set(range(bits)) - forced), ones - len(forced))
        return sum(1 << b for b in forced | set(rest))
    return prng.getrandbits(bits) | sum(1 << b for b in forced)


def statements(traffic: dict, enc_bits: int, seed: int):
    """An endless stream of the traffic's statements, as dicts of ints with
    the expected ciphertext under `res`."""
    kind = traffic["statement"]
    prng = random.Random(derive(seed, f"statements:{kind}"))
    fixed = {k: draw(prng, enc_bits, spec) for k, spec in traffic.get("per_run", {}).items()}
    while True:
        st = {**fixed, **{k: draw(prng, enc_bits, spec) for k, spec in traffic["per_step"].items()}}
        if kind == "paillier_encrypt":
            st["res"] = paillier_encrypt(st["n"], st["g"], st["m"], st["r"])
        elif kind == "paillier_add":
            st["res"] = paillier_add(st["n"], st["c1"], st["c2"])
        else:
            raise ValueError(f"unknown statement kind {kind!r}")
        yield st


def uniform_fr_limbs(log2_points: int, seed: int, step: int, device):
    """(8, 2^log2_points) int32 limbs of uniform values below
    floor(r / 2^224) * 2^224, read as Montgomery forms: each coefficient is
    that value times 2^-256 mod r. The vector of step `step` of the run
    with `seed`, drawn in one call per limb group."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(int.from_bytes(derive(seed, f"coefficients:{step}")[:8], "little"))
    m = 1 << log2_points
    low = torch.randint(0, 1 << 32, (7, m), generator=gen, device=device, dtype=torch.int64)
    top = torch.randint(0, R >> 224, (1, m), generator=gen, device=device, dtype=torch.int64)
    limbs = torch.cat([low, top])
    return torch.where(limbs >= 1 << 31, limbs - (1 << 32), limbs).to(torch.int32)
