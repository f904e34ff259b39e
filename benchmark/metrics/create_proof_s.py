"""`create_proof_s`: mean seconds of the benchmark's span around
`create_proof`, ending in `torch.cuda.synchronize()`, over the window's
proofs."""
from .common import span_mean


def read(obs: dict):
    return span_mean(obs, "create_proof_s")
