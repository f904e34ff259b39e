"""`proof_s`: the window's seconds over the proofs completed in it."""


def read(obs: dict):
    w = obs["window"]
    return w["seconds"] / w["steps"] if w["steps"] else None
