"""Milliseconds an epoch of the SR apply's damped solves of both Fisher
blocks: the program's ``sr.solve`` span, its seconds over its calls (one a
epoch), read from its registry (``coulombgas_tpu_torch/ops/counters.py``).
Nothing to read where the program keeps no such span."""


def read(run):
    from coulombgas_tpu_torch.ops import counters

    span = getattr(counters, "spans", {}).get("sr.solve")
    if not span or not span["calls"]:
        return None
    return 1e3 * span["seconds"] / span["calls"]
