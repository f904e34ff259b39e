"""Plain checks of a synthesized circuit table and of the Paillier
statements it claims to compute.

The table is the program's state after synthesis. The reference cannot
synthesize the circuit again, so it checks the table by the semantics of
the gate system (every gate, copy, constant and lookup) and reads the
ciphertext out of the cells the circuit returned, against Paillier worked
out here with Python's own integers.
"""
from __future__ import annotations

import numpy as np

from .bn254 import R


def paillier_encrypt(n: int, g: int, m: int, r: int) -> int:
    n2 = n * n
    return pow(g, m, n2) * pow(r, n, n2) % n2


def paillier_add(n: int, c1: int, c2: int) -> int:
    return c1 * c2 % (n * n)


def recompose(values, idx, limb_bits: int) -> int:
    return sum(int(values[i]) << (limb_bits * j) for j, i in enumerate(idx))


def violations(table, lookup_bits: int) -> int:
    """Gates, copies, constants and lookups the table's values break:
    w[i] + w[i+1] w[i+2] == w[i+3] at every gate start i, copied cells
    equal, constant cells equal to their constants, lookup cells in
    [0, 2^lookup_bits), every value in Fr."""
    vals = np.asarray(table.values, dtype=object)
    bad = sum(1 for v in vals if not 0 <= int(v) < R)
    g = np.asarray(table.gates, dtype=np.int64)
    bad += int(np.count_nonzero((vals[g] + vals[g + 1] * vals[g + 2] - vals[g + 3]) % R != 0))
    bad += int(np.count_nonzero(vals[np.asarray(table.copy_a, dtype=np.int64)]
                                != vals[np.asarray(table.copy_b, dtype=np.int64)]))
    cv = np.asarray([int(v) for v in table.const_val], dtype=object)
    bad += int(np.count_nonzero(vals[np.asarray(table.const_idx, dtype=np.int64)] != cv))
    lk = vals[np.asarray(table.lookups, dtype=np.int64)]
    bad += sum(1 for v in lk if not 0 <= int(v) < (1 << lookup_bits))
    return bad
