"""The plain reference the benchmark holds the program to: plain PyTorch,
one module per architecture family (``dense_lm``) and one for FetchSGD's
sketch and server step (``sketch``).  It imports nothing of the program."""
