"""Sample-quality evaluation (port of dddpm_tpu/evaluation/): the
InceptionV3 extractor, FID / sFID / IS, precision / recall, the
Evaluator and the test-set loss helper."""
