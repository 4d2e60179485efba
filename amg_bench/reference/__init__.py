"""The plain reference: NumPy, SciPy and PyTorch only, nothing of the program."""
