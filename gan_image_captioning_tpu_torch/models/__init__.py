"""The LSTM generator as ``nn.Module``s and plain functions on tensors."""
