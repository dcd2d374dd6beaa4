"""Evaluation metrics of the port: VQA accuracy and the caption metrics
(BLEU, METEOR, ROUGE-L, CIDEr-D over PTB-tokenized text)."""
