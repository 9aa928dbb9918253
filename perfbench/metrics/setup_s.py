"""setup_s: seconds from the start of the run to the opening of the ramp:
imports, weights, plans, the warm-up traffic and its graph captures (or the
training step's first steps)."""


def read(rec):
    return rec["setup_s"]
