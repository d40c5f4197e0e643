"""Special tokens (``gan_image_captioning_tpu/data/vocab.py``)."""

SPECIAL_TOKENS = ("<PAD>", "<S>", "<E>", "<UNK>")
PAD, START, END, UNK = 0, 1, 2, 3
