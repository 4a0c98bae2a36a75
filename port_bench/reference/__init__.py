"""Plain PyTorch references, one file a family (``<family>.py``), named
by each configuration's ``family``. They import nothing of the program."""
