"""`synth_pool_s`: mean seconds, over the window's proofs, from handing a
batch's instances to the witness pool until every instance's table is back
in the parent, pickling included (`synth_parallel`'s `stats["pool_s"]`,
the program's host clock)."""
from .common import span_mean


def read(obs: dict):
    return span_mean(obs, "synth_pool_s")
