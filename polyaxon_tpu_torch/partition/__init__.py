"""Parameter paths and foreign-checkpoint import/export of the port
(counterparts of ``polyaxon_tpu/partition``, on one device)."""

from .rules import path_str, tree_paths

__all__ = ["path_str", "tree_paths"]
