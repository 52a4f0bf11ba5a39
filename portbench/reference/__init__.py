"""Plain PyTorch references of what the cells run; they import nothing of
the port."""
