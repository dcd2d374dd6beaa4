"""Models of the port: BEiT-2, the text/fusion encoder, XFMBase and the
pretrain and retrieval heads."""
from .beit2 import BeitVisionTransformer, VisionConfig
from .task_models import XFMForPretrain, XFMForRetrieval
from .text_encoder import TextConfig, TextTransformer
from .xfm import XFMBase, XFMConfig

__all__ = ["BeitVisionTransformer", "VisionConfig", "TextConfig",
           "TextTransformer", "XFMBase", "XFMConfig", "XFMForPretrain",
           "XFMForRetrieval"]
