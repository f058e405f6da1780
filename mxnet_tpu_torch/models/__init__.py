"""Model symbols of the port: the ResNet family
(``models.resnet.get_symbol(num_layers=50)``), the bucketed LSTM language
model (``lstm_lm_sym_gen``, ``lstm_lm_serving_sym_gen``) and the SSD-VGG16
detector's inference symbol (``models.ssd.get_symbol``)."""

from . import resnet, ssd  # noqa: F401
from .lstm_lm import lstm_lm_serving_sym_gen, lstm_lm_sym_gen  # noqa: F401
