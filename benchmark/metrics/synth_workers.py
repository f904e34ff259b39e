"""`synth_workers`: mean number of distinct worker processes that
synthesized a batch's instances, over the window's proofs
(`synth_parallel`'s `stats["workers"]`); it equals the configured workers
where the pool did the work, and reads 1 where synthesis fell back to the
serial path."""
from .common import span_mean


def read(obs: dict):
    return span_mean(obs, "synth_workers")
