"""Models of the pretrain slice: BEiT-2, the text/fusion encoder, XFMBase."""
from .beit2 import BeitVisionTransformer, VisionConfig
from .task_models import XFMForPretrain
from .text_encoder import TextConfig, TextTransformer
from .xfm import XFMBase, XFMConfig

__all__ = ["BeitVisionTransformer", "VisionConfig", "TextConfig",
           "TextTransformer", "XFMBase", "XFMConfig", "XFMForPretrain"]
