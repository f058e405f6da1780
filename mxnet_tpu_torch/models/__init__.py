"""Model symbols of the port (the ResNet family so far):
``models.resnet.get_symbol(num_layers=50)``."""

from . import resnet  # noqa: F401
