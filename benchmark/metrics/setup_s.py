"""`setup_s`: process start to the first timed step, on the host's clock."""


def read(obs: dict):
    return obs["setup_s"]
