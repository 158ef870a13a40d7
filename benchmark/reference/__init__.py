"""The plain reference the benchmark judges the program by: float32
PyTorch and NumPy that import nothing of the program, and the judgement."""
