"""Plain PyTorch references, one file a family (``<family>.py``, whose
``train`` hands its model to ``core.py``'s step loop), named by each
configuration's ``family``. They import nothing of the program."""
