"""Model symbols of the port: the ResNet family
(``models.resnet.get_symbol(num_layers=50)``), the bucketed LSTM language
model (``lstm_lm_sym_gen``, ``lstm_lm_serving_sym_gen``), the SSD-VGG16
detector (``models.ssd.get_symbol``, ``get_symbol_train``) and DCGAN's
generator and discriminator (``dcgan_generator``,
``dcgan_discriminator``)."""

from . import resnet, ssd  # noqa: F401
from .dcgan import make_discriminator as dcgan_discriminator  # noqa: F401
from .dcgan import make_generator as dcgan_generator  # noqa: F401
from .lstm_lm import lstm_lm_serving_sym_gen, lstm_lm_sym_gen  # noqa: F401
