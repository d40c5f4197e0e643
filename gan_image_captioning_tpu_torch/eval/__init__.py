"""Caption decoding and post-processing."""
