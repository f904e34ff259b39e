"""`synth_merge_s`: mean seconds, over the window's proofs, of merging a
batch's instance tables into one and rebasing each instance's ciphertext
cells (`synth_parallel`'s `stats["merge_s"]`, the program's host clock)."""
from .common import span_mean


def read(obs: dict):
    return span_mean(obs, "synth_merge_s")
