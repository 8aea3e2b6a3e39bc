"""``mt.rnn`` — symbolic recurrent cells and the bucketing iterator (the
reference's ``mx.rnn``)."""
from .rnn_cell import *  # noqa: F401,F403
from .io import *  # noqa: F401,F403

from . import rnn_cell
from . import io

__all__ = rnn_cell.__all__ + io.__all__
