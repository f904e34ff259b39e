"""`launches_per_proof`: kernels on the device in the profiled proofs, hand
written and PyTorch's alike (copies and fills left out), per proof."""


def read(obs: dict):
    tr = obs.get("trace")
    return tr["launches"] / tr["steps"] if tr and tr["steps"] else None
