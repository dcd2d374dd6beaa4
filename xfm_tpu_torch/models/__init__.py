"""Models of the port: BEiT-2, CLIP-ViT, the text/fusion encoder and the
causal decoder with its decode cache, XFMBase and the pretrain,
retrieval, VQA, captioning, NLVR2, grounding and classification heads,
caption decoding and GradCAM; the VQ-KD tokenizer and its teachers."""
from .beit2 import BeitVisionTransformer, VisionConfig
from .clip_vit import ClipVisionConfig, ClipVisionTransformer
from .generation import (XFMForCaptioning, XFMForVQA, beam_generate,
                         generate, top_k_top_p_filtering)
from .gradcam import itm_gradcam, rank_boxes_by_cam
from .teachers import CLIPTeacher, DINOTeacher
from .task_models import (DeepMLPHead, TextClassifier,
                          XFMForClassification, XFMForGrounding, XFMForNLVR,
                          XFMForPretrain, XFMForRetrieval)
from .text_encoder import DecodeCache, TextConfig, TextTransformer
from .vqkd import VQKD, VQKDConfig, vqkd_config_from_yaml
from .xfm import XFMBase, XFMConfig, config_from_yaml

__all__ = ["BeitVisionTransformer", "VisionConfig", "ClipVisionConfig",
           "ClipVisionTransformer", "CLIPTeacher", "DINOTeacher", "VQKD",
           "VQKDConfig", "DecodeCache", "DeepMLPHead",
           "TextClassifier", "TextConfig", "TextTransformer", "XFMBase",
           "XFMConfig", "XFMForCaptioning", "XFMForClassification",
           "XFMForGrounding", "XFMForNLVR", "XFMForPretrain",
           "XFMForRetrieval", "XFMForVQA", "beam_generate",
           "config_from_yaml", "generate", "itm_gradcam",
           "rank_boxes_by_cam", "top_k_top_p_filtering",
           "vqkd_config_from_yaml"]
