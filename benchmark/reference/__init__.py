"""Plain PyTorch reference of the decoding problem; imports nothing of the program."""
