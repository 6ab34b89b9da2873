"""The plain references that decide ``correct``: PyTorch only, importing
nothing of the program."""
