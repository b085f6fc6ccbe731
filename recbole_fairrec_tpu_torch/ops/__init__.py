"""Device ops: the fused top-k kernel wrapper and plain-PyTorch eval ops."""
