"""``gluon.rnn`` — recurrent cells and the fused recurrent layers."""
from .rnn_cell import *  # noqa: F401,F403
from .rnn_layer import *  # noqa: F401,F403

from . import rnn_cell
from . import rnn_layer

__all__ = rnn_cell.__all__ + rnn_layer.__all__
