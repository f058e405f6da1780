"""Model symbols of the port: the ResNet family
(``models.resnet.get_symbol(num_layers=50)``) and the bucketed LSTM
language model (``lstm_lm_sym_gen``, ``lstm_lm_serving_sym_gen``)."""

from . import resnet  # noqa: F401
from .lstm_lm import lstm_lm_serving_sym_gen, lstm_lm_sym_gen  # noqa: F401
