"""Offline data factory: split -> render (latex/dvipng/ImageMagick, or
matplotlib's mathtext) -> prune -> pickle, on the host, as the JAX package's
factory does, without PIL, PyYAML (a ``.json`` data config) or ``regex``."""
