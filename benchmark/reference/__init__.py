"""The plain PyTorch reference the benchmark compares the program against; it imports nothing of the program."""
