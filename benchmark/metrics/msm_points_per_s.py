"""`msm_points_per_s`: the points of every commitment completed in the
window, over the window's seconds."""


def read(obs: dict):
    w = obs["window"]
    return w["work"] / w["seconds"] if w["steps"] else None
