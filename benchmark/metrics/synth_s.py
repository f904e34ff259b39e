"""`synth_s`: mean seconds of the benchmark's span around witness synthesis
(`Context()`, the circuit function, `finalize()`), over the window's proofs."""
from .common import span_mean


def read(obs: dict):
    return span_mean(obs, "synth_s")
