"""Seconds of the rollout graphs' captures in set-up (layer: rollout graph,
``models/rollout_graph.py``): the port's own counter,
``SliceGraph.captures_seconds`` (each capture's eager warm-up slice, the
capture and the instantiation, host clock), read when set-up ends."""


def read(r):
    return r.layer.get("capture_s")
