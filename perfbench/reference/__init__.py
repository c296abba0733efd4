"""The plain reference of the cells: plain PyTorch and NumPy, nothing of
the program."""
