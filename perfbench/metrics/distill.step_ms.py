"""ms a distillation step takes on the host's clock: the unprofiled window's
wall time over its steps, the window ending in a synchronise (the step time a
user pays, which the host paces in part)."""


def read(r):
    return 1e3 * r.wall_per_unit_s if r.unit == "step" else None
