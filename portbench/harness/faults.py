"""Planting a fault in the program's timed path, for the check's tests and
the calibration's readings."""


def patch(module, name: str, make):
    """Replace ``module.name`` by ``make(original)``; returns the undo."""
    orig = getattr(module, name)
    setattr(module, name, make(orig))
    return lambda: setattr(module, name, orig)
