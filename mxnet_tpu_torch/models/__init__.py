"""Model symbols of the port: the MNIST MLP and LeNet (``models.mlp``,
``models.lenet``), the ResNet family (``models.resnet(num_layers=50)``, a
function, as in the JAX package), the bucketed LSTM language model
(``lstm_lm_sym_gen``, ``lstm_lm_serving_sym_gen``), the SSD-VGG16 detector
(``models.ssd.get_symbol``, ``get_symbol_train``) and DCGAN's generator and
discriminator (``dcgan_generator``, ``dcgan_discriminator``)."""

from . import ssd  # noqa: F401
from .dcgan import make_discriminator as dcgan_discriminator  # noqa: F401
from .dcgan import make_generator as dcgan_generator  # noqa: F401
from .lenet import get_symbol as lenet  # noqa: F401
from .lstm_lm import lstm_lm_serving_sym_gen, lstm_lm_sym_gen  # noqa: F401
from .mlp import get_symbol as mlp  # noqa: F401
from .resnet import get_symbol as resnet  # noqa: F401
