"""RNN toolkit (reference ``python/mxnet/rnn/``; a copy of
``mxnet_tpu/rnn/__init__.py``)."""

from .rnn_cell import (
    BaseRNNCell,
    BidirectionalCell,
    DropoutCell,
    FusedRNNCell,
    GRUCell,
    LSTMCell,
    ModifierCell,
    ResidualCell,
    RNNCell,
    RNNParams,
    SequentialRNNCell,
    ZoneoutCell,
)
from .io import BucketSentenceIter, encode_sentences


def save_rnn_checkpoint(cells, prefix, epoch, symbol, arg_params, aux_params):
    """Save checkpoint with cells' weights packed (reference rnn_cell)."""
    if isinstance(cells, BaseRNNCell):
        cells = [cells]
    for cell in cells:
        arg_params = cell.pack_weights(arg_params)
    from ..model import save_checkpoint

    save_checkpoint(prefix, epoch, symbol, arg_params, aux_params)


def load_rnn_checkpoint(cells, prefix, epoch):
    """Load checkpoint, unpacking fused cell weights (reference)."""
    from ..model import load_checkpoint

    sym, arg, aux = load_checkpoint(prefix, epoch)
    if isinstance(cells, BaseRNNCell):
        cells = [cells]
    for cell in cells:
        arg = cell.unpack_weights(arg)
    return sym, arg, aux


def do_rnn_checkpoint(cells, prefix, period=1):
    """Epoch checkpoint callback packing RNN weights (reference)."""
    period = int(max(1, period))

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period == 0:
            save_rnn_checkpoint(cells, prefix, iter_no + 1, sym, arg, aux)

    return _callback
