# LM-architecture substrate of the port, dense family: the config schema
# (config), the layers (layers) and the model with its serving entry
# points (transformer).  Import the submodules directly.
from repro_torch.models.config import ArchConfig  # noqa: F401
