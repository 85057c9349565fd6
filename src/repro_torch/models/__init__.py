"""Model zoo: the dense, vlm, encoder, moe, ssm and hybrid families in
PyTorch (the port of ``repro.models``)."""
from .common import ArchConfig
from .model_api import Model, build_model

__all__ = ["ArchConfig", "build_model", "Model"]
