"""Evaluation of the port: VQA accuracy, the caption metrics (BLEU, METEOR,
ROUGE-L, CIDEr-D over PTB-tokenized text) and the REFER annotations of
grounding."""
