"""Device kernels launched by one sample step, counted in the traced epoch."""


def read(run):
    p = run.profile
    steps = len(p.phases.get("sample", [])) if p is not None else 0
    return p.launches("sample") / steps if steps else None
