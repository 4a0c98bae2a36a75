"""The bert family's layout: the learned-position transformer's
(``learned_pos.py``)."""

from port_bench.layouts.learned_pos import layout, stated  # noqa: F401
