"""The plain PyTorch / NumPy reference the benchmark holds pcf_torch
against. It imports nothing of pcf_torch."""
