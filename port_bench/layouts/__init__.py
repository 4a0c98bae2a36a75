"""Parameter layouts and size checks, one file a family (``<family>.py``),
named by each configuration's ``family``: ``layout(cfg)`` gives every
leaf's path, shape, scale, offset and whether it is layer-stacked, and
``stated(model)`` the program's configuration under the configuration
file's keys. They import nothing of the program."""
