"""The plain reference: plain PyTorch, no import of the program."""
