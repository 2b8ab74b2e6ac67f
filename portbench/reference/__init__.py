"""The plain reference: PyTorch and NumPy only, nothing of motionstyle_torch."""
