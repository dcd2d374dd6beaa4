"""Models of the port: BEiT-2, CLIP-ViT, the text/fusion encoder and the
causal answer decoder, XFMBase and the pretrain, retrieval and VQA
heads."""
from .beit2 import BeitVisionTransformer, VisionConfig
from .clip_vit import ClipVisionConfig, ClipVisionTransformer
from .generation import XFMForVQA
from .task_models import XFMForPretrain, XFMForRetrieval
from .text_encoder import TextConfig, TextTransformer
from .xfm import XFMBase, XFMConfig, config_from_yaml

__all__ = ["BeitVisionTransformer", "VisionConfig", "ClipVisionConfig",
           "ClipVisionTransformer", "TextConfig",
           "TextTransformer", "XFMBase", "XFMConfig", "XFMForPretrain",
           "XFMForRetrieval", "XFMForVQA", "config_from_yaml"]
