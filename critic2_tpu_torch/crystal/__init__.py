from .crystal import Crystal, Species  # noqa: F401
