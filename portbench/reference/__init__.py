"""Plain PyTorch SegCLIP: the reference that decides `correct`. Imports nothing of the program."""
