"""`keygen_s`: mean seconds of the benchmark's span around keygen
(`plonk.keygen.keygen` on the step's own table, ending in
`torch.cuda.synchronize()`), over the window's proofs, in cells whose
traffic makes a key for every statement."""
from .common import span_mean


def read(obs: dict):
    return span_mean(obs, "keygen_s")
