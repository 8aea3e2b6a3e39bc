"""What the examples share: the fit harness (:mod:`.fit`) and the gate
check."""


class GateFailure(AssertionError):
    """An example missed its gate."""


def gate(ok: bool, message: str) -> None:
    """An example's gate: raises :class:`GateFailure` unless ``ok``."""
    if not ok:
        raise GateFailure(message)
