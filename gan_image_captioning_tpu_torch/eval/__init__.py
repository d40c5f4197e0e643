"""Caption decoding (greedy, beam, sampled) and the caption-quality
metrics."""
