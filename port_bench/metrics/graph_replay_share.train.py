"""graph_replay_share.train (%): the window's steps that replayed a
captured CUDA graph (``StagedSteps.replays``), over the window's steps.
Layer: the train loop, ``train/chunk``."""


def read(rec):
    if rec.get("kind") != "train" or not rec.get("steps"):
        return None
    return 100.0 * rec["replays"] / rec["steps"]
