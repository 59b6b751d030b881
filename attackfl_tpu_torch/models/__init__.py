"""Model zoo; importing registers every model under its reference class
name (CNNModel, RNNModel, TransformerModel, TransformerClassifier,
ResNet18)."""

from attackfl_tpu_torch.models import har, icu, resnet  # noqa: F401
