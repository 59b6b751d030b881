"""Model zoo (ICU TransformerModel so far); importing registers it."""

from attackfl_tpu_torch.models import icu  # noqa: F401
